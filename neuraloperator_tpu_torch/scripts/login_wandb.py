"""Log in to Weights & Biases with the configured API key (port of
``scripts/login_wandb.py``): ``WANDB_API_KEY``, else
``config/wandb_api_key.txt``; prints whether it logged in.

Usage:
  python -m neuraloperator_tpu_torch.scripts.login_wandb
"""

from ..utils import wandb_login


def main() -> bool:
    ok = wandb_login()
    print("wandb: logged in" if ok else "wandb: not logged in (no wandb package or no key)")
    return ok


if __name__ == "__main__":
    main()
