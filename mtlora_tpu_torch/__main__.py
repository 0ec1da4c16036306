"""``python -m mtlora_tpu_torch --cfg FILE ...``: the training and
evaluation CLI (``main.py``)."""

from mtlora_tpu_torch.main import cli

if __name__ == "__main__":
    cli()
