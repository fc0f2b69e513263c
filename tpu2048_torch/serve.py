"""Model inference server: POST a board, get the policy's move.

Counterpart of ``tpu2048/serve.py``, with the same endpoints and answers:

  POST /predict   {"board": [[...4x4 exponents...]], "greedy": false,
                   "search": 0}
      -> {"action": 0..3, "direction": "UP", "probs": [...4], "value": v,
          "legal": [bool x4]}
  POST /predict_batch {"boards": [[[...]], ...]} -> {"actions": [...], ...}
  GET  /healthz   -> {"status": "ok", "model": {...}}

``"search": 1``/``2``/``3`` picks the move by expectimax search of that depth
(``algo/search.py``) instead of the raw policy; the answer then carries the
per-action ``search_scores`` (``None`` for an illegal action) beside the
policy's probs and value. The search coefficients come from the checkpoint's
train state (``load_search_coefs``; pure EV with a warning without one). At
depth 3 the inner max nodes are pruned to the top 2 actions by 1-ply score
and a batch is scored 16 boards at a time, as the JAX server does.

Every request runs the merge (legality, and every level of a search) and the
model forward on the service's device: on CUDA, the merge is the
hand-written kernel. MLP and URM checkpoints alike.

Usage: python -m tpu2048_torch.serve --checkpoint checkpoints_expG
           [--port 8787] [--host 127.0.0.1] [--device cuda]

The JAX server's flags, plus ``--device``; its ``--platform`` raises
``NotImplementedError`` naming ``--device``, as the CLI's subcommands do.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from . import DIRECTION_NAMES
from .algo.search import expectimax_scores
from .env import engine
from .models.encoding import encode_boards
from .train.evaluate import load_model_checkpoint, load_search_coefs


class PolicyService:
    """Loads a checkpoint and answers masked-policy queries, batched."""

    def __init__(self, checkpoint_path: str, device: str | torch.device = "cuda"):
        self.model, self.model_cfg, self.model_type = load_model_checkpoint(
            checkpoint_path, device)
        self.device = next(self.model.parameters()).device
        # Host-side sampling stream, seeded as the reference's.
        self._rng = np.random.default_rng(0)
        self._search_coefs = load_search_coefs(checkpoint_path)

    # Depth-3 guards, as in the JAX server: the exact inner tree is
    # (4*32)^2 subproblems per board, so inner max nodes keep the top 2
    # actions, and a batch is scored in chunks of 16 boards to bound the
    # memory of one call.
    DEPTH3_PRUNE_K = 2
    DEPTH3_CHUNK = 16

    @torch.inference_mode()
    def _search_scores(self, boards: np.ndarray, depth: int) -> np.ndarray:
        b = torch.as_tensor(boards, dtype=torch.int32, device=self.device)
        prune_k = self.DEPTH3_PRUNE_K if depth >= 3 else 0
        chunk = self.DEPTH3_CHUNK if depth >= 3 else max(len(b), 1)
        scores = [expectimax_scores(self.model, part, None, self._search_coefs,
                                    depth, prune_k) for part in b.split(chunk)]
        return torch.cat(scores).cpu().numpy()

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
        boards = np.asarray(boards, np.int32)
        squeeze = boards.ndim == 2
        if squeeze:
            boards = boards[None]
        if boards.ndim != 3 or boards.shape[1:] != (4, 4):
            raise ValueError(f"boards must be 4x4, got shape {boards.shape}")
        probs, value, legal = self._forward(boards)
        search_scores = None
        if search:
            depth = max(1, min(int(search), 3))
            search_scores = self._search_scores(boards, depth)
            actions = search_scores.argmax(-1)
        elif greedy:
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
        if search_scores is not None:
            # -inf (illegal) is not JSON; clients read legality from "legal".
            out["search_scores"] = np.where(
                np.isfinite(search_scores), search_scores, None).tolist()
        if squeeze:
            out = {
                "action": out["actions"][0],
                "direction": out["directions"][0],
                "probs": out["probs"][0],
                "value": out["values"][0],
                "legal": out["legal"][0],
                **({"search_scores": out["search_scores"][0]}
                   if search_scores is not None else {}),
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


def main(argv=None) -> None:
    from .train.cli import check_platform

    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", "-c", default="checkpoints")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--host", default="127.0.0.1",
                    help="Bind address (default loopback; pass 0.0.0.0 to "
                         "expose on all interfaces — there is no auth)")
    ap.add_argument("--platform", default=None,
                    help="The JAX package's platform switch; the port's is --device")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    check_platform(args)
    service = PolicyService(args.checkpoint, args.device)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"Serving {service.info()} on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
