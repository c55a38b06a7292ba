"""The port's FederatedServer against the JAX server under the paper's
baseline schemes and the registry's other schemes, at tests/test_sim.py's
size (N = 10, pool 700, J = 3, 3 rounds): winners and cluster labels bit
for bit, the weight-delta features within 1e-5, params within 1e-4, and
FedProx at nu = 0.5 as figures 7 and 8 run it; and the batched
weight-feature pass against the per-client loop."""
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.core import clustering as JCL
from repro.core.adapters import cnn_adapter as j_adapter
from repro.core.server import FederatedServer as JServer
from repro.data.partition import partition_clients
from repro.data.synthetic import make_image_dataset
from repro_torch import interop
from repro_torch.configs.base import FLConfig
from repro_torch.core import clustering as TCL
from repro_torch.core.adapters import cnn_adapter as t_adapter
from repro_torch.core.server import SCHEME_METRIC_KEYS
from repro_torch.core.server import FederatedServer as TServer

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

KW = dict(num_clients=10, num_clusters=3, select_ratio=0.4, rounds=3,
          local_epochs=2, sample_window=10, cluster_resamples=2,
          init_energy_mode="normal", seed=3)


@pytest.fixture(scope="module")
def data():
    train, test = make_image_dataset("mnist", n_train=700, n_test=120,
                                     seed=3)
    return train, {"x": test.x[:64], "y": test.y[:64]}


def _record_projection(monkeypatch, module):
    """Keep the raw (N, D) features each stage 1 hands the projection."""
    seen = []
    proj = module.project_features_blocked

    def recording(key, feats, out_dim, *a, **k):
        seen.append(np.asarray(feats))
        return proj(key, feats, out_dim, *a, **k)

    monkeypatch.setattr(module, "project_features_blocked", recording)
    return seen


def _servers(data, runtime="sequential", **kw):
    train, test_batch = data
    kw = dict(KW, **kw)
    clients = partition_clients(train.y, JConfig(**kw), seed=3)
    js = JServer(JConfig(**kw), j_adapter("mnist"), train.x, train.y,
                 clients, test_batch)
    ts = TServer(FLConfig(**kw, runtime=runtime), t_adapter("mnist", "cpu"),
                 train.x, train.y, clients, test_batch, device="cpu")
    # start from the JAX server's exact parameters and energy
    ts.params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in js.params.items()}, "cpu")
    ts.state.residual = torch.tensor(np.asarray(js.state.residual))
    return js, ts


def _assert_runs_agree(js, ts, j_logs, t_logs):
    np.testing.assert_array_equal(ts.state.clusters.numpy(),
                                  np.asarray(js.state.clusters))
    assert len(t_logs) == len(j_logs) == KW["rounds"]
    for a, b in zip(j_logs, t_logs):
        np.testing.assert_array_equal(b.selected, a.selected)
        for f in ("energy_std", "mean_bid", "vds_gap", "server_reward",
                  "client_reward_sum", "test_acc", "test_loss"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(ts.state.history.numpy(),
                                  np.asarray(js.state.history))
    for k, v in js.params.items():
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4, err_msg=k)
    assert sum(len(l.selected) for l in t_logs) > 0


@pytest.mark.parametrize("kw", [
    {"scheme": "gradient_cluster_random"},
    {"scheme": "weights_cluster_random"},
    {"scheme": "random"},
    {"scheme_select": "fedcs", "fedcs_deadline": 1.0},
    {"scheme_select": "longterm_auction"},
    {"aggregator": "fedprox", "non_iid_level": 0.5},
], ids=["gradient_cluster_random", "weights_cluster_random", "random",
        "select-fedcs", "select-longterm_auction", "fedprox-nu0.5"])
def test_server_matches_jax_server(data, monkeypatch, kw):
    j_feats = _record_projection(monkeypatch, JCL)
    t_feats = _record_projection(monkeypatch, TCL)
    js, ts = _servers(data, **kw)
    j_logs, t_logs = js.run(), ts.run()
    _assert_runs_agree(js, ts, j_logs, t_logs)
    assert len(t_feats) == len(j_feats)
    if kw.get("scheme") == "random":
        assert not t_feats          # no stage 1
        assert not ts.state.clusters.any()
    else:
        # the CNN's 21,840-wide features, before the JL projection
        assert t_feats[0].shape == j_feats[0].shape == (10, 21840)
        np.testing.assert_allclose(t_feats[0], j_feats[0], rtol=0,
                                   atol=1e-5)
    for a, b in zip(j_logs, t_logs):
        assert set(b.scheme_metrics) <= set(SCHEME_METRIC_KEYS)
        assert "fairness_hist_std" in b.scheme_metrics
    select = kw.get("scheme_select")
    if select == "longterm_auction":
        for k in ("spent", "queue", "paid"):
            np.testing.assert_allclose(
                getattr(ts.state.scheme_state, k).numpy(),
                np.asarray(getattr(js.state.scheme_state, k)),
                rtol=1e-6, atol=1e-6, err_msg=k)
        assert {"budget_spent", "budget_remaining",
                "budget_queue"} <= set(t_logs[0].scheme_metrics)
    if select == "fedcs":
        assert {"pred_latency_mean",
                "num_feasible"} <= set(t_logs[0].scheme_metrics)


@pytest.mark.parametrize("runtime", ["vectorized"])
def test_batched_weight_features_match_the_loop(data, monkeypatch, runtime):
    """``engine.weight_features`` (one batched pass; the device runtime
    inherits this pass) against the server's per-client
    ``local_steps_fn`` loop: features within 1e-5, the same clusters and
    winners."""
    feats = _record_projection(monkeypatch, TCL)
    runs = {}
    for rt in ("sequential", runtime):
        _, ts = _servers(data, runtime=rt, scheme="weights_cluster_random")
        runs[rt] = (ts, ts.run())
    np.testing.assert_allclose(feats[1], feats[0], rtol=0, atol=1e-5)
    (seq, seq_logs), (bat, bat_logs) = runs["sequential"], runs[runtime]
    assert torch.equal(bat.state.clusters, seq.state.clusters)
    for a, b in zip(seq_logs, bat_logs):
        np.testing.assert_array_equal(b.selected, a.selected)
