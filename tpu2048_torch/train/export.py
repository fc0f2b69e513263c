"""Demo-asset export (counterpart of ``tpu2048/train/export.py``): the ONNX
model, ``model_config.json`` and ``best_game.json`` the ``web/`` demo loads,
plus ``model_weights.json``, the raw weights its dependency-free JS forward
pass (``web/js/mlp.js``, ``web/js/urm.js``) reads when ONNX Runtime Web is
unavailable.

The exporters take a port model (or the JAX params tree
``checkpoint.state_dict_to_params`` gives) and write, for the same weights,
the same bytes as the JAX package's.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np
import torch

from ..utils import viz_export
from ..utils.onnx_writer import export_mlp, export_urm
from .checkpoint import state_dict_to_params


def _params(model_or_params) -> dict:
    if isinstance(model_or_params, torch.nn.Module):
        return state_dict_to_params(model_or_params)
    return model_or_params


def export_demo_assets(model_or_params, model_cfg, model_type: str, best_episode,
                       output_dir, search_coefs=None,
                       play_meta: dict | None = None) -> None:
    """Write ``best_game.json`` (when ``best_episode`` is given),
    ``model.onnx``, ``model_config.json`` (with ``search_coefs``, the
    demo's in-browser expectimax coefficients, when given) and
    ``model_weights.json`` into ``output_dir``."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    if best_episode:
        viz_export.export_best_game(best_episode, out / "best_game.json",
                                    meta=play_meta)
    else:
        print("Warning: No best game to export (no games were played)")

    exporter = export_urm if model_type.lower() == "urm" else export_mlp
    np_params = _params(model_or_params)
    exporter(np_params, model_cfg, out / "model.onnx")
    print(f"Model exported to {out / 'model.onnx'}")

    cfg_dict = dict(model_cfg.to_dict(), model_type=model_type.lower())
    if search_coefs is not None:
        cfg_dict["search_coefs"] = dict(search_coefs._asdict())
    with open(out / "model_config.json", "w") as f:
        json.dump(cfg_dict, f, indent=2)

    export_weights_json(np_params, model_cfg, out / "model_weights.json",
                        model_type=model_type)
    print(f"Raw weights exported to {out / 'model_weights.json'}")


def _tensor_b64(a: np.ndarray) -> dict:
    """Exact float32 tensor as {shape, data}: little-endian f32 base64,
    4 bytes a parameter, decoded in JS with atob + Float32Array."""
    a = np.ascontiguousarray(a, dtype="<f4")
    return {"shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def _heads(np_params: dict) -> dict:
    return {head: {k: _tensor_b64(np_params[head][k]) for k in ("w", "b")}
            for head in ("action_head", "value_head")}


def _stem(np_params: dict) -> dict:
    stem = np_params["stem"]
    return {"w": _tensor_b64(stem["lin"]["w"]), "ln_g": _tensor_b64(stem["ln"]["g"]),
            "ln_b": _tensor_b64(stem["ln"]["b"])}


def export_weights_json(model_or_params, model_cfg, path,
                        model_type: str = "mlp") -> None:
    """Raw weights for the pure-JS forward. The MLP's layout follows its
    forward: the stem Linear(48->h, no bias) + LN + ReLU; blocks of
    x + ReLU(LN(Linear(x))); biased action and value heads. The URM's:
    the per-cell stem, ``init_hidden`` (16, h), each block's attention
    (``qkv``, ``o``) and ConvSwiGLU (``gate_up``, the depthwise conv,
    ``down``), the heads. Inference runs every recurrent loop alike."""
    np_params = _params(model_or_params)
    if model_type.lower() == "urm":
        doc = {
            "format": "tpu2048-urm-weights-v1",
            "config": model_cfg.to_dict(),
            "stem": _stem(np_params),
            "init_hidden": _tensor_b64(np_params["init_hidden"][0]),  # (16, h)
            "blocks": [
                {"qkv": _tensor_b64(b["qkv"]["w"]),
                 "o": _tensor_b64(b["o"]["w"]),
                 "gate_up": _tensor_b64(b["gate_up"]["w"]),
                 "dwconv_w": _tensor_b64(b["dwconv"]["w"]),
                 "dwconv_b": _tensor_b64(b["dwconv"]["b"]),
                 "down": _tensor_b64(b["down"]["w"])}
                for b in np_params["blocks"]
            ],
            **_heads(np_params),
        }
    else:
        doc = {
            "format": "tpu2048-mlp-weights-v1",
            "config": model_cfg.to_dict(),
            "stem": _stem(np_params),
            "blocks": [
                {"w": _tensor_b64(b["lin"]["w"]),
                 "ln_g": _tensor_b64(b["ln"]["g"]),
                 "ln_b": _tensor_b64(b["ln"]["b"])}
                for b in np_params["blocks"]
            ],
            **_heads(np_params),
        }
    with open(path, "w") as f:
        json.dump(doc, f)
