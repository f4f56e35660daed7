from winograd_tpu_torch.datagen.generate import main

if __name__ == "__main__":
    raise SystemExit(main())
