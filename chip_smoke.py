#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (winograd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc.
Phases, each of which must pass (exit 1 otherwise):

1. device: a CUDA device is required (no CPU continuation); TF32 is turned
   off for cuBLAS and cuDNN so the plain versions and the library
   yardsticks compute in full float32. Prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles csrc/*.cu with nvcc for sm_90a, one process per source.
3. serving: ResNet50Engine with seeded full-width weights answers N=1
   requests and N=8 requests on the JAX package's fused route. The launch
   counters are zeroed just before and read just after; each forward must
   launch stem 1, pointwise 8, Winograd 1, stage 3, transition 3 and
   direct 2 times. One image's logits must agree with the same
   model through the plain versions on the CPU in float64 within
   1e-4 * max(1, max|golden|); every row of the N=8 logits must agree with
   that image's N=1 logits within the same bound. The first N=1 forward's
   launches, recorded by shape in kernels/_build.py, are the shape list of
   phase 4.
4. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the served forward gave it, and at shapes off the served
   N=1 list (Winograd F(4,3) at 14x14x128; the block at bench modes 6 and
   9; the conv4_x stage and the 14->7 transition at N=8; the conv5_x stage
   geometry), max abs error <= 1e-4 * max(1, max|plain|) on seeded
   unit-scale inputs. One JSON
   line per shape: error; device times of the kernel, its plain version and
   the library call (20 calls captured in a CUDA graph, the median of 20
   replays between CUDA events, divided by 20; inputs stay in L2 between
   calls); "wrapper_ms", one eager wrapper call between CUDA events, host
   path included (median of 20 after 2 warm-ups); and the bound: the larger
   of FLOPs over the FP32 peak and bytes over HBM bandwidth (H100 SXM data
   sheet: 67 TFLOP/s FP32, 3.35 TB/s). The stage and transition rows time
   a cooperative launch, which CUDA graphs capture like any other.
5. profile: torch.profiler over 5 N=1 and 3 N=8 requests served as in
   phase 3, each ended by a synchronize (after the launch counts were
   read): device time by kernel name per request, and the device's idle
   share, 1 - device busy time over the host clock of the profiled
   requests (an upper bound for unprofiled serving: the profiler adds host
   time).
6. a "kernels" JSON line (per-image sums over the main path's shapes), the
   card line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np

FP32_FLOPS = 67e12   # H100 SXM, FP32 outside the tensor cores, dense
HBM_BYTES_S = 3.35e12
ATOL = 1e-4
EXPECTED_PER_FORWARD = {
    "stem": 1, "pointwise": 8, "winograd": 1, "stage": 3, "transition": 3, "direct": 2,
}
SOURCES = {
    "pointwise": ("winograd_tpu/kernels/pointwise.py:67",
                  ["winograd_tpu/kernels/pointwise.py:67 _matmul_bn_kernel"]),
    "winograd": ("winograd_tpu/kernels/winograd.py:384",
                 ["winograd_tpu/kernels/winograd.py:384 _winograd_kernel",
                  "winograd_tpu/kernels/winograd.py:252 _winograd_kernel_p64"]),
    "direct": ("winograd_tpu/kernels/direct.py:97",
               ["winograd_tpu/kernels/direct.py:97 _direct_kernel"]),
    "stem": ("winograd_tpu/kernels/stem.py:59",
             ["winograd_tpu/kernels/stem.py:59 _stem_kernel"]),
    "stage": ("winograd_tpu/kernels/stage.py:129",
              ["winograd_tpu/kernels/stage.py:129 _stage_kernel",
               "winograd_tpu/kernels/stage.py:169 _stage_kernel_resident",
               "winograd_tpu/kernels/block.py:32 _block_kernel",
               "winograd_tpu/kernels/block.py:150 _block_kernel_winograd"]),
    "transition": ("winograd_tpu/kernels/transition.py:38",
                   ["winograd_tpu/kernels/transition.py:38 _transition_kernel",
                    "winograd_tpu/kernels/transition.py:119 _transition_kernel_resident"]),
}


def _rand(rng, *shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def _winograd_transform_flops(m):
    """FLOPs of the input transform per tile and input channel, and of the
    output transform per tile and output channel, counting only the nonzero
    entries of Bt and At, as csrc/winograd.cu's sandwich() computes them
    (one FMA, two FLOPs, each)."""
    from winograd_tpu_torch.kernels import transforms

    bt, _, at = transforms.matrices(m)
    a = m + 2
    return 2 * (2 * a * np.count_nonzero(bt)), 2 * ((a + m) * np.count_nonzero(at))


def _kernel_name(key):
    """A profiler event's kernel name without namespace, template or
    arguments; PyTorch's own kernels are lumped as "pytorch_ops"."""
    if "at::native" in key:
        return "pytorch_ops"
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0].strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    import torch.nn.functional as F

    from winograd_tpu_torch.config import ResNet50Config
    from winograd_tpu_torch.engine import ResNet50Engine
    from winograd_tpu_torch.kernels import _build, transforms
    from winograd_tpu_torch.kernels.direct import (
        conv3x3_bn_direct, conv3x3_bn_direct_plain, direct_filter,
    )
    from winograd_tpu_torch.kernels.pointwise import conv1x1_bn, conv1x1_bn_plain
    from winograd_tpu_torch.kernels.stage import (
        resnet_stage_fused, resnet_stage_fused_plain, stack_stage_params,
    )
    from winograd_tpu_torch.kernels.stem import stem_fused, stem_fused_plain
    from winograd_tpu_torch.kernels.transition import (
        fuse_transition_weights, transition_block_fused, transition_block_fused_plain,
    )
    from winograd_tpu_torch.kernels.winograd import (
        conv3x3_bn_winograd, conv3x3_bn_winograd_plain,
    )
    from winograd_tpu_torch.models.convert import params_from_jax, stem_filter_s2d
    from winograd_tpu_torch.models.resnet50 import (
        init_resnet50_arrays, init_resnet50_params, resnet50_forward,
    )

    dev = torch.device("cuda", 0)
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
            print(f"FAIL: {what}", file=sys.stderr)

    build_s = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": build_s}), flush=True)

    def t(a):
        return torch.as_tensor(a, device=dev)

    def bn(rng, c):
        gamma, beta, mean = _rand(rng, c), _rand(rng, c), _rand(rng, c)
        var = (rng.random(c) * 3 + 5).astype(np.float32)
        s, b = transforms.fold_batchnorm(gamma, beta, mean, var)
        return t(s), t(b)

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def wrapper_ms(fn, reps=20, warmup=2):
        """One eager call between two events: device time plus whatever host
        time the device waits for."""
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            a, b = events()
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def device_ms(fn, calls=20, reps=20, warmup=2):
        """Device time per call: `calls` calls captured in one CUDA graph,
        the median of `reps` replays between two events, over `calls`."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        pairs = []
        for _ in range(reps):
            a, b = events()
            a.record()
            graph.replay()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs) / calls

    def bound(flops, nbytes):
        ops_ms, bytes_ms = 1e3 * flops / FP32_FLOPS, 1e3 * nbytes / HBM_BYTES_S
        return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")

    def nchw(x):
        return x.permute(0, 3, 1, 2)

    # -- cases: (kernel fn, plain fn, library fn, flops, bytes) ----
    def pointwise_case(rng, p, k, n, relu):
        x, w = t(_rand(rng, p, k)), t(_rand(rng, k, n))
        s, b = bn(rng, n)
        return (lambda: conv1x1_bn(x, w, s, b, relu),
                lambda: conv1x1_bn_plain(x, w, s, b, relu),
                lambda: torch.matmul(x, w),
                2 * p * k * n, 4 * (p * k + k * n + p * n + 2 * n))

    def conv3x3_inputs(rng, n, h, w, cin, cout):
        x, wt = t(_rand(rng, n, h, w, cin)), _rand(rng, cout, cin, 3, 3)
        s, b = bn(rng, cout)
        w_cl = t(wt).contiguous(memory_format=torch.channels_last)
        return x, wt, s, b, lambda: F.conv2d(nchw(x), w_cl, padding=1)

    def winograd_case(rng, n, h, w, cin, cout, m, relu):
        x, wt, s, b, lib = conv3x3_inputs(rng, n, h, w, cin, cout)
        u = t(transforms.transform_filter(wt, m=m))
        a2, nt = (m + 2) ** 2, n * (-(-h // m)) * (-(-w // m))
        fwd, inv = _winograd_transform_flops(m)
        flops = 2 * a2 * nt * cin * cout + nt * (fwd * cin + inv * cout)
        return (lambda: conv3x3_bn_winograd(x, u, s, b, relu),
                lambda: conv3x3_bn_winograd_plain(x, u, s, b, relu),
                lib, flops, 4 * (n * h * w * (cin + cout) + a2 * cin * cout + 2 * cout))

    def direct_case(rng, n, h, w, cin, cout, relu):
        x, wt, s, b, lib = conv3x3_inputs(rng, n, h, w, cin, cout)
        w9 = t(direct_filter(wt))
        return (lambda: conv3x3_bn_direct(x, w9, s, b, relu),
                lambda: conv3x3_bn_direct_plain(x, w9, s, b, relu),
                lib, 2 * n * h * w * 9 * cin * cout,
                4 * (n * h * w * (cin + cout) + 9 * cin * cout + 2 * cout))

    def stem_case(rng, n, h, w, cin, c):
        x, w7 = t(_rand(rng, n, h, w, cin)), _rand(rng, c, cin, 7, 7)
        s, b = bn(rng, c)
        w192 = t(stem_filter_s2d(w7))
        w7_cl = t(w7).contiguous(memory_format=torch.channels_last)
        ho, wo, po, qo = -(-h // 2), -(-w // 2), -(-h // 4), -(-w // 4)
        return (lambda: stem_fused(x, w192, s, b),
                lambda: stem_fused_plain(x, w192, s, b),
                lambda: F.max_pool2d(F.conv2d(nchw(x), w7_cl, stride=2, padding=3), 3, 2, 1),
                2 * n * ho * wo * 49 * cin * c,
                4 * (n * h * w * cin + 64 * cin * c + n * po * qo * c + 2 * c))

    def conv3x3_filter(rng, cin, cout):
        w = _rand(rng, cout, cin, 3, 3)
        return w, t(w).contiguous(memory_format=torch.channels_last)

    def stage_case(rng, n, h, w, cio, cmid, nb, mid):
        blocks, lib_w = [], []
        for _ in range(nb):
            wm, wm_cl = conv3x3_filter(rng, cmid, cmid)
            (s1, b1), (s2, b2), (s3, b3) = bn(rng, cmid), bn(rng, cmid), bn(rng, cio)
            blocks.append(dict(
                w_reduce=t(_rand(rng, cio, cmid)), s_reduce=s1, b_reduce=b1,
                u2_mid=t(transforms.transform_filter(wm, m=2)), w9_mid=t(direct_filter(wm)),
                s_mid=s2, b_mid=b2, w_expand=t(_rand(rng, cmid, cio)), s_expand=s3, b_expand=b3))
            lib_w.append((blocks[-1]["w_reduce"], wm_cl, blocks[-1]["w_expand"]))
        stacked = stack_stage_params(blocks)
        x = t(_rand(rng, n, h, w, cio))

        def lib():
            y = x
            for wr, wm_cl, we in lib_w:
                y = torch.matmul(y, wr)
                y = F.conv2d(nchw(y), wm_cl, padding=1).permute(0, 2, 3, 1)
                y = torch.matmul(y, we)
            return y

        p = n * h * w
        if mid == "winograd2":
            nt = n * (-(-h // 2)) * (-(-w // 2))
            fwd, inv = _winograd_transform_flops(2)
            mid_flops, mid_elems = 2 * 16 * nt * cmid * cmid + nt * (fwd + inv) * cmid, 16 * cmid * cmid
        else:
            mid_flops, mid_elems = 2 * p * 9 * cmid * cmid, 9 * cmid * cmid
        flops = nb * (4 * p * cio * cmid + mid_flops)
        nbytes = 4 * (2 * p * cio + nb * (2 * cio * cmid + mid_elems + 4 * cmid + 2 * cio))
        return (lambda: resnet_stage_fused(x, stacked, mid),
                lambda: resnet_stage_fused_plain(x, stacked, mid), lib, flops, nbytes)

    def transition_case(rng, n, h, w, cin, cmid, cout):
        wm, wm_cl = conv3x3_filter(rng, cmid, cmid)
        (s1, b1), (s2, b2), (s3, b3), (sp, bp) = (bn(rng, c) for c in (cmid, cmid, cout, cout))
        params = dict(w_reduce=t(_rand(rng, cin, cmid)), s_reduce=s1, b_reduce=b1,
                      w9_mid=t(direct_filter(wm)), s_mid=s2, b_mid=b2,
                      w_expand=t(_rand(rng, cmid, cout)), s_expand=s3, b_expand=b3,
                      w_proj=t(_rand(rng, cin, cout)), s_proj=sp, b_proj=bp)
        params["wep"], params["bep"] = fuse_transition_weights(params)
        x = t(_rand(rng, n, h, w, cin))

        def lib():
            y = torch.matmul(x, params["w_reduce"])
            y = F.conv2d(nchw(y), wm_cl, stride=2, padding=1).permute(0, 2, 3, 1)
            return (torch.matmul(y, params["w_expand"])
                    + torch.matmul(x[:, ::2, ::2, :], params["w_proj"]))

        ho, wo = -(-h // 2), -(-w // 2)
        flops = 2 * n * (h * w * cin * cmid + ho * wo * (9 * cmid * cmid + (cmid + cin) * cout))
        nbytes = 4 * (n * h * w * cin + n * ho * wo * cout + cin * cmid + 9 * cmid * cmid
                      + (cmid + cin) * cout + 4 * cmid + cout)
        return (lambda: transition_block_fused(x, params),
                lambda: transition_block_fused_plain(x, params), lib, flops, nbytes)

    # -- serving at full width ---------------------------------------------
    cfg = ResNet50Config()
    params = init_resnet50_params(cfg, seed=0, device=dev)
    engine = ResNet50Engine(params, device=dev)
    rng = np.random.default_rng(1)
    images = _rand(rng, 8, cfg.img, cfg.img, 3)
    n_single, n_batch = 10, 3
    _build.reset_counts()
    single = {0: engine(images[0])}
    torch.cuda.synchronize()
    shapes = {name: collections.Counter(c) for name, c in _build.LAUNCH_SHAPES.items()}
    lat = []
    for i in range(n_single):
        t0 = time.perf_counter()
        logits = engine(images[i % 8])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        single.setdefault(i % 8, logits)
    batch_s = []
    for _ in range(n_batch):
        t0 = time.perf_counter()
        logits8 = engine(images)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    forwards = 1 + n_single + n_batch
    for name, per in EXPECTED_PER_FORWARD.items():
        check(launches.get(name, 0) == per * forwards,
              f"{name}: {launches.get(name, 0)} launches in {forwards} forwards, want {per} each")
        check(sum(shapes.get(name, {}).values()) == per,
              f"{name}: first forward launched {dict(shapes.get(name, {}))}, want {per}")

    golden = resnet50_forward(
        images[0], params_from_jax(init_resnet50_arrays(cfg, seed=0), "cpu", torch.float64),
        device="cpu",
    ).numpy()
    got = single[0].double().cpu().numpy()
    tol = ATOL * max(1.0, float(np.abs(golden).max()))
    err = float(np.abs(got - golden).max())
    check(got.shape == (cfg.num_classes,) and np.isfinite(got).all() and err <= tol,
          f"N=1 logits vs float64 CPU golden: max abs err {err} > {tol}")
    ref8 = torch.stack([single[i] for i in range(8)])
    err8 = float((logits8.double() - ref8.double()).abs().max())
    check(tuple(logits8.shape) == (8, cfg.num_classes) and bool(torch.isfinite(logits8).all())
          and err8 <= tol, f"N=8 logits vs each image's N=1 logits: {err8}")
    print(json.dumps({
        "phase": "serving", "n1_latency_ms_median": 1e3 * statistics.median(lat),
        "n1_latency_ms": [1e3 * v for v in lat],
        "n8_images_per_s": 8 / statistics.median(batch_s),
        "golden_max_abs_err": err, "golden_tol": tol, "golden_max_abs": float(np.abs(golden).max()),
        "n8_vs_n1_max_abs_err": err8, "launches": launches, "forwards": forwards,
    }), flush=True)

    from torch.profiler import ProfilerActivity, profile

    for n, reps in ((1, 5), (8, 3)):
        engine(images[:n])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                engine(images[:n])
                torch.cuda.synchronize()
            window_ms = 1e3 * (time.perf_counter() - t0) / reps
        by_name = collections.defaultdict(float)
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0:
                by_name[_kernel_name(e.key)] += e.device_time_total / reps / 1e3
        busy = sum(by_name.values())
        check(0 < busy <= window_ms, f"profile N={n}: device busy {busy} ms of {window_ms} ms")
        print(json.dumps({
            "phase": "profile", "n": n, "device_busy_ms": busy, "request_ms": window_ms,
            "idle_share": 1 - busy / window_ms,
            "device_ms_by_kernel": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
        }), flush=True)

    make_case = {"pointwise": pointwise_case, "winograd": winograd_case,
                 "direct": direct_case, "stem": stem_case, "stage": stage_case,
                 "transition": transition_case}
    # Off the served N=1 list: F(4,3) accuracy at the mode-0 shape; the
    # block at modes 6 and 9; the batched layouts' cases (rows 7 and 9 of
    # the TPU kernel table) at N=8; the conv5_x stage geometry, which the
    # served route runs per layer.
    extra = {
        "winograd": [(1, 14, 14, 128, 128, 4, True)],
        "stage": [(1, 14, 14, 1024, 256, 1, "direct"), (1, 28, 28, 512, 128, 1, "winograd2"),
                  (8, 14, 14, 1024, 256, 5, "direct"), (1, 7, 7, 2048, 512, 2, "direct")],
        "transition": [(8, 14, 14, 1024, 512, 2048)],
    }
    totals = {}
    rng = np.random.default_rng(0)
    for name in EXPECTED_PER_FORWARD:
        counter = shapes.get(name, collections.Counter())
        tot = collections.defaultdict(float)
        tot["max_abs_err"] = 0.0
        for shape in list(counter) + extra.get(name, []):
            per_image = counter.get(shape, 0)
            kern, plain, lib, flops, nbytes = make_case[name](rng, *shape)
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            finite = bool(torch.isfinite(got).all())
            tol = ATOL * max(1.0, ref.abs().max().item())
            check(finite and err <= tol, f"{name}{shape}: max abs err {err} > {tol} (finite={finite})")
            ms, plain_ms, lib_ms = device_ms(kern), device_ms(plain), device_ms(lib)
            host_ms = wrapper_ms(kern)
            bound_ms, bound_by = bound(flops, nbytes)
            print(json.dumps({
                "kernel": name, "shape": shape, "per_image": per_image,
                "max_abs_err": err, "tol": tol, "ms": ms, "wrapper_ms": host_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "gflops_s": flops / ms / 1e6,
            }), flush=True)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            for key, v in (("ms", ms), ("wrapper_ms", host_ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms),
                           ("ops_ms", 1e3 * flops / FP32_FLOPS),
                           ("bytes_ms", 1e3 * nbytes / HBM_BYTES_S),
                           ("bound_ms", bound_ms)):
                tot[key] += per_image * v
        totals[name] = tot

    kernels = []
    for name, tot in totals.items():
        replaces, covers = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"winograd_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "covers": covers, "launches": launches.get(name, 0),
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "wrapper_ms": tot["wrapper_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
