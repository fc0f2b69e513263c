"""Model inference server: POST a board, get the policy's move.

Counterpart of ``tpu2048/serve.py``, with the same endpoints and answers:

  POST /predict   {"board": [[...4x4 exponents...]], "greedy": false}
      -> {"action": 0..3, "direction": "UP", "probs": [...4], "value": v,
          "legal": [bool x4]}
  POST /predict_batch {"boards": [[[...]], ...]} -> {"actions": [...], ...}
  GET  /healthz   -> {"status": "ok", "model": {...}}

Every request runs the merge (legality) and the model forward on the
service's device: on CUDA, the merge is the hand-written kernel.
``"search" > 0`` (expectimax) is not yet ported and answers 400.

Usage: python -m tpu2048_torch.serve --checkpoint checkpoints_expG
           [--port 8787] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from . import DIRECTION_NAMES
from .env import engine
from .models.encoding import encode_boards
from .train.evaluate import load_model_checkpoint


class PolicyService:
    """Loads a checkpoint and answers masked-policy queries, batched."""

    def __init__(self, checkpoint_path: str, device: str | torch.device = "cuda"):
        self.model, self.model_cfg, self.model_type = load_model_checkpoint(
            checkpoint_path, device)
        self.device = next(self.model.parameters()).device
        # Host-side sampling stream, seeded as the reference's.
        self._rng = np.random.default_rng(0)

    @torch.inference_mode()
    def _forward(self, boards: np.ndarray) -> tuple:
        b = torch.as_tensor(boards, dtype=torch.int32, device=self.device)
        moves = engine.all_moves(b)
        logits, value = self.model(encode_boards(b))
        mask = moves.action_mask
        masked = logits.masked_fill(mask, float("-inf"))
        all_invalid = mask.all(-1, keepdim=True)
        probs = torch.softmax(torch.where(all_invalid, torch.zeros_like(masked),
                                          masked), dim=-1)
        probs = probs.masked_fill(mask, 0.0)
        return (probs.cpu().numpy(), value[..., 0].cpu().numpy(),
                torch.logical_not(mask).cpu().numpy())

    def info(self) -> dict:
        return {"model_type": self.model_type, "config": self.model_cfg.to_dict()}

    def predict(self, boards: np.ndarray, greedy: bool = False,
                search: int = 0) -> dict:
        if search:
            raise ValueError("search not yet ported in tpu2048_torch")
        boards = np.asarray(boards, np.int32)
        squeeze = boards.ndim == 2
        if squeeze:
            boards = boards[None]
        if boards.ndim != 3 or boards.shape[1:] != (4, 4):
            raise ValueError(f"boards must be 4x4, got shape {boards.shape}")
        probs, value, legal = self._forward(boards)
        if greedy:
            actions = probs.argmax(-1)
        else:
            cum = probs.cumsum(-1)
            cum = cum / np.maximum(cum[..., -1:], 1e-9)
            u = self._rng.random((boards.shape[0], 1))
            # A board with no legal move has all-zero probs; it gets action 0,
            # as the greedy argmax gives (the JAX server indexes past the
            # direction names there and fails the request).
            actions = np.where(legal.any(-1), (u > cum).sum(-1), 0)
        out = {
            "actions": actions.tolist(),
            "directions": [DIRECTION_NAMES[a] for a in actions],
            "probs": probs.tolist(),
            "values": value.tolist(),
            "legal": legal.tolist(),
        }
        if squeeze:
            out = {
                "action": out["actions"][0],
                "direction": out["directions"][0],
                "probs": out["probs"][0],
                "value": out["values"][0],
                "legal": out["legal"][0],
            }
        return out


def make_handler(service: PolicyService):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json({"status": "ok", "model": service.info()})
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/predict":
                    boards = payload["board"]
                elif self.path == "/predict_batch":
                    boards = payload["boards"]
                else:
                    self._json({"error": "not found"}, 404)
                    return
                self._json(service.predict(np.asarray(boards),
                                           payload.get("greedy", False),
                                           payload.get("search", 0)))
            except (KeyError, ValueError, TypeError) as e:
                self._json({"error": str(e)}, 400)

        def log_message(self, fmt, *args):
            pass

    return Handler


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", "-c", default="checkpoints")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--host", default="127.0.0.1",
                    help="Bind address (default loopback; pass 0.0.0.0 to "
                         "expose on all interfaces — there is no auth)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args()
    service = PolicyService(args.checkpoint, args.device)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"Serving {service.info()} on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
