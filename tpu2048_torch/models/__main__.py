"""Smoke block (counterpart of ``tpu2048/models/__main__.py``): 3 fresh
boards, a GameMLP and a GameURM forward at H=64 with live heads, their
shapes and parameter counts (the same counts as the JAX package's).

    python -m tpu2048_torch.models [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..env import engine
from .encoding import encode_boards
from .mlp import GameMLP, MLPConfig
from .urm import GameURM, URMConfig


def num_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m tpu2048_torch.models")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain merge)")
    device = resolve_device(ap.parse_args(argv).device)
    boards = engine.reset(3, device, generator=torch.Generator(device).manual_seed(0))
    stacked = encode_boards(boards)

    print("=== Testing GameMLP ===")
    model = GameMLP(MLPConfig(hidden_dim=64), zero_heads=False,
                    generator=torch.Generator().manual_seed(1)).to(device).eval()
    logits, value = model(stacked)
    print(f"Action logits shape: {tuple(logits.shape)}")
    print(f"Value shape: {tuple(value.shape)}")
    print(f"Action logits:\n{logits.cpu().numpy()}")

    print("\n=== Testing GameURM ===")
    ucfg = URMConfig(hidden_dim=64, num_loops=4, num_truncated_loops=1)
    umodel = GameURM(ucfg, zero_heads=False,
                     generator=torch.Generator().manual_seed(2)).to(device).eval()
    ulogits, uvalue = umodel(stacked)
    print(f"Action logits shape: {tuple(ulogits.shape)}")
    print(f"Value shape: {tuple(uvalue.shape)}")
    print(f"Action logits:\n{ulogits.cpu().numpy()}")

    print("\n=== Parameter Counts ===")
    counts = {"GameMLP": num_params(model), "GameURM": num_params(umodel)}
    for name, n in counts.items():
        print(f"{name}: {n:,} parameters")
    return dict(counts, logits=logits, value=value, urm_logits=ulogits, urm_value=uvalue)


if __name__ == "__main__":
    main()
