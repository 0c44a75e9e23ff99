"""`python -m ray_tpu_torch <cmd>`: the CLI entrypoint (scripts.py)."""

from ray_tpu_torch.scripts import main

main()
