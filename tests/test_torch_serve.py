"""The port's policy server (tpu2048_torch/serve.py) against tpu2048.serve on
a checkpoint the JAX package writes, and its HTTP endpoints."""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest

from tests.conftest import random_board_np
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.serve import PolicyService as JPolicyService
from tpu2048.train import checkpoint as JCKPT
from tpu2048_torch.serve import PolicyService, make_handler

# Float32 forward sums are taken in another order in the two frameworks.
TOL = 1e-5


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve_ckpt")
    cfg = JMLPConfig(hidden_dim=32, num_layers=1)
    params = jmlp.init(jax.random.key(0), cfg, zero_heads=False)
    JCKPT.save_checkpoint(
        d, "best_model", arrays_tree=dict(params=params),
        manifest=dict(config=cfg.to_dict(), model_type="mlp",
                      eval_avg_score=0.0, train_step=0))
    return d


@pytest.fixture(scope="module")
def services(ckpt_dir):
    return PolicyService(str(ckpt_dir), device="cpu"), JPolicyService(str(ckpt_dir))


def _boards(n, dead=True):
    """Random boards; with ``dead``, the first one has no legal move."""
    rng = np.random.default_rng(3)
    b = np.stack([random_board_np(rng) for _ in range(n)])
    if dead:
        b[0] = (np.indices((4, 4)).sum(0) % 2 + 1)
    return b


@pytest.mark.parametrize("greedy", [True, False])
def test_predict_matches_jax_service(ckpt_dir, greedy):
    """Fresh services on both sides, so the sampling streams start alike.
    Sampled, a board with no legal move fails the JAX service's request
    (IndexError), so that case is held by the next test on the port alone."""
    svc, jsvc = PolicyService(str(ckpt_dir), device="cpu"), JPolicyService(str(ckpt_dir))
    boards = _boards(64, dead=greedy)
    for batch in (boards, boards[5]):
        got = svc.predict(batch, greedy=greedy)
        want = jsvc.predict(batch, greedy=greedy)
        single = batch.ndim == 2
        assert set(got) == set(want)
        for key in ("probs", "value" if single else "values"):
            np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL)
        assert got["legal"] == want["legal"]
        act = "action" if single else "actions"
        assert got[act] == want[act]


def test_predict_probs_are_a_masked_distribution(services):
    svc, _ = services
    for greedy in (True, False):
        out = svc.predict(_boards(32), greedy=greedy)
        probs, legal = np.asarray(out["probs"]), np.asarray(out["legal"])
        assert not legal[0].any() and (probs[0] == 0).all()
        assert out["actions"][0] == 0 and out["directions"][0] == "UP"
        assert (probs[~legal] == 0).all()
        np.testing.assert_allclose(probs[1:].sum(1), 1.0, atol=TOL)
        assert all(legal[i, a] for i, a in enumerate(out["actions"]) if i)


def test_search_not_yet_ported(services):
    svc, _ = services
    with pytest.raises(ValueError, match="search not yet ported in tpu2048_torch"):
        svc.predict(_boards(2), search=1)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_http_endpoints(services):
    svc, _ = services
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "model": svc.info()}

        board = [[1, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]
        one = _post(base + "/predict", {"board": board, "greedy": True})
        assert one["direction"] in ("UP", "DOWN", "LEFT", "RIGHT")
        assert one["legal"] == [False, True, True, True]
        assert one["legal"][one["action"]]

        many = _post(base + "/predict_batch", {"boards": [board, board]})
        assert len(many["actions"]) == 2 and len(many["probs"]) == 2

        for path, payload in (("/predict", {}),
                              ("/predict", {"board": board, "search": 2}),
                              ("/predict", {"board": [[1, 2], [3, 4]]})):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, payload)
            assert e.value.code == 400
            if "search" in payload:
                assert "search not yet ported" in json.loads(e.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/nope", {})
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
