from winograd_tpu_torch.bench.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
