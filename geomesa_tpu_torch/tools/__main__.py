"""``python -m geomesa_tpu_torch.tools <subcommand>``: the command line."""

from geomesa_tpu_torch.tools.cli import main

if __name__ == "__main__":
    main()
