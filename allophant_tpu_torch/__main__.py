"""`python -m allophant_tpu_torch` runs the main `allophant` CLI of the port."""

from allophant_tpu_torch.cli.run import main

if __name__ == "__main__":
    main()
