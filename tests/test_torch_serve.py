"""The port's policy server (tpu2048_torch/serve.py) against tpu2048.serve on
a checkpoint the JAX package writes, in every mode (sampled, greedy, search
of depth 1 to 3), and its HTTP endpoints."""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import random_board_np
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.algo.advantage import RtgMoments
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.serve import PolicyService as JPolicyService
from tpu2048.train import checkpoint as JCKPT
from tpu2048_torch.serve import PolicyService, make_handler

# Float32 forward sums are taken in another order in the two frameworks.
TOL = 1e-5
# Search scores are float32 sums over 32 spawn slots per level on top.
SEARCH_TOL = 1e-4


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
def search_ckpt_dir(tmp_path_factory):
    """A best_model beside a train_state whose RTG moments and reward
    weights give nontrivial search coefficients."""
    d = tmp_path_factory.mktemp("torch_serve_search_ckpt")
    cfg = JMLPConfig(hidden_dim=32, num_layers=1)
    params = jmlp.init(jax.random.key(4), cfg, zero_heads=False)
    JCKPT.save_checkpoint(
        d, "best_model", arrays_tree=dict(params=params),
        manifest=dict(config=cfg.to_dict(), model_type="mlp",
                      eval_avg_score=0.0, train_step=50))
    moments = RtgMoments(jnp.asarray(3.0), jnp.asarray(25.0), jnp.asarray(3.0))
    JCKPT.save_checkpoint(
        d, "train_state", arrays_tree=dict(params=params, moments=moments),
        manifest=dict(model_config=cfg.to_dict(), model_type="mlp", train_step=50,
                      config=dict(points_weight=0.1, monotonicity_weight=0.7,
                                  emptiness_weight=0.3, gamma=0.97, rtg_beta=0.9)))
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


def _assert_search_matches_jax(ckpt_dir, depth, n):
    """``search_scores`` (None where illegal), actions and the policy fields
    of fresh services on both sides, on /predict_batch and (below depth 3,
    whose tree costs seconds a board here) /predict. At depth 3 the port
    scores one board per call (``DEPTH3_CHUNK`` = 1), so the batch crosses
    its chunks."""
    svc = PolicyService(str(ckpt_dir), device="cpu")
    jsvc = JPolicyService(str(ckpt_dir))
    assert tuple(svc._search_coefs) == tuple(jsvc._search_coefs)
    assert svc._search_coefs.sigma != 1.0
    svc.DEPTH3_CHUNK = 1
    boards = _boards(n, dead=True)
    for batch in (boards, boards[1])[:2 if depth < 3 else 1]:
        got = svc.predict(batch, search=depth)
        want = jsvc.predict(batch, search=depth)
        single = batch.ndim == 2
        assert set(got) == set(want) and "search_scores" in got
        g = np.asarray(got["search_scores"], dtype=object).reshape(-1, 4)
        w = np.asarray(want["search_scores"], dtype=object).reshape(-1, 4)
        np.testing.assert_array_equal(g == None, w == None)  # noqa: E711
        legal = np.asarray(got["legal"]).reshape(-1, 4)
        np.testing.assert_array_equal(g != None, legal)  # noqa: E711
        np.testing.assert_allclose(g[legal].astype(float), w[legal].astype(float),
                                   rtol=SEARCH_TOL, atol=SEARCH_TOL)
        act = "action" if single else "actions"
        assert got[act] == want[act]
        np.testing.assert_allclose(got["probs"], want["probs"], rtol=TOL, atol=TOL)
        assert got["legal"] == want["legal"]


def test_search_not_yet_ported(search_ckpt_dir):
    """Search of depth 1 answers as the JAX service does. (The name dates
    from before the search was ported, when this test pinned its refusal.)"""
    _assert_search_matches_jax(search_ckpt_dir, 1, 8)


@pytest.mark.parametrize("depth,n", [(2, 3), (3, 2)])
def test_search_matches_jax_service(search_ckpt_dir, depth, n):
    _assert_search_matches_jax(search_ckpt_dir, depth, n)


def test_search_depth_is_clamped(services):
    """``search`` beyond 1..3 is clamped into it, as the JAX server does."""
    svc, _ = services
    boards = _boards(2)
    deep = svc.predict(boards, search=1)
    assert svc.predict(boards, search=-4)["search_scores"] == deep["search_scores"]


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

        searched = _post(base + "/predict", {"board": board, "search": 2})
        assert searched["search_scores"][0] is None
        assert all(isinstance(v, float) for v in searched["search_scores"][1:])
        assert searched["legal"][searched["action"]]
        batch = _post(base + "/predict_batch", {"boards": [board, board], "search": 1})
        assert len(batch["search_scores"]) == 2

        for path, payload in (("/predict", {}),
                              ("/predict", {"board": board, "search": "deep"}),
                              ("/predict", {"board": [[1, 2], [3, 4]]})):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, payload)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/nope", {})
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def _server_flags(path) -> set:
    """The option strings of the ``ap.add_argument`` calls in a server's
    ``main``."""
    import ast

    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    return {a.value for call in ast.walk(main) if isinstance(call, ast.Call)
            and getattr(call.func, "attr", None) == "add_argument"
            for a in call.args if isinstance(a, ast.Constant)}


def test_platform_raises_naming_device_and_the_flags_are_the_servers(tmp_path):
    """``--platform`` (the JAX server's device switch) raises before a model
    loads, naming --device; the port's server takes the JAX server's flags
    and --device, no other."""
    from pathlib import Path

    import tpu2048.serve as jserve
    from tpu2048_torch import serve as tserve

    with pytest.raises(NotImplementedError, match="--device"):
        tserve.main(["--platform", "cpu", "--checkpoint", str(tmp_path / "none")])
    ours, theirs = _server_flags(Path(tserve.__file__)), _server_flags(Path(jserve.__file__))
    assert "--platform" in theirs and ours - theirs == {"--device"} and theirs <= ours
