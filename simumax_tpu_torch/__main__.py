from simumax_tpu_torch.cli import main

if __name__ == "__main__":
    main()
