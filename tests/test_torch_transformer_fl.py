"""Transformer FL in the port against the JAX package, on the CPU, at
tests/test_system.py::test_transformer_fl_loop's size (qwen2-0.5b's
smoke config, 8 clients, 2 clusters, 2 rounds, sequences of 16 tokens):
the stage-1 gradient features of every runtime, and the whole loop on
``sequential``, ``vectorized`` and ``device`` from the JAX server's
initial params and energies (carried across through numpy).

Tolerances: features within 1e-5 absolute (the runtimes sum the same
float32 gradients in other orders); cluster labels and every round's
winners identical; round metrics within 1e-5; final params within 1e-4
(the reference's engine-vs-oracle bound, tests/test_sim.py)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import clustering as JCL
from repro.core.adapters import transformer_adapter as j_adapter
from repro.core.server import FederatedServer as JServer
from repro.data.partition import partition_clients
from repro.data.synthetic import make_token_dataset
from repro_torch import interop, rng
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.core import clustering as TCL
from repro_torch.core.adapters import transformer_adapter as t_adapter
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.sim.runtime import make_runtime

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

ARCH = "qwen2-0.5b"
KW = dict(num_clients=8, num_clusters=2, select_ratio=0.25, rounds=2,
          lr=0.1, non_iid_level=1.0, scheme="gradient_cluster_auction",
          num_classes=4, sample_window=6, cluster_resamples=2)
RUNTIMES = ("sequential", "vectorized", "device")
FEAT_TOL = 1e-5
PARAMS_TOL = 1e-4


@pytest.fixture(scope="module")
def data():
    toks, topics = make_token_dataset(num_topics=4, vocab=256, seq_len=16,
                                      n=240, seed=0)
    clients = partition_clients(topics, JConfig(**KW), seed=0)
    return toks, topics, clients, {"x": toks[:32], "y": topics[:32]}


@pytest.fixture(scope="module")
def jax_run(data):
    """The JAX sequential server: (initial params tree, initial residual,
    logs, cluster labels, final params tree), numpy."""
    toks, topics, clients, test = data
    js = JServer(JConfig(**KW), j_adapter(j_smoke(ARCH)), toks, topics,
                 clients, test)
    start = (jax.tree.map(np.asarray, js.params),
             np.asarray(js.state.residual))
    logs = js.run()
    return start + (logs, np.asarray(js.state.clusters),
                    jax.tree.map(np.asarray, js.params))


def _max_diff(a, b) -> float:
    return max(float(np.abs(x - y).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_stage1_features_match_jax(data, jax_run, runtime):
    """Mean sample-window gradients (255,472 wide) against the JAX
    package's per-client loop on the same params and key."""
    toks, topics, clients, _ = data
    tree = jax_run[0]
    cfg = FLConfig(**dict(KW, runtime=runtime))
    params = interop.flat_params_from_numpy(tree, t_smoke(ARCH), "cpu")
    adapter = t_adapter(t_smoke(ARCH), "cpu")
    rt = make_runtime(cfg, adapter, toks, topics, clients, "cpu")
    key = rng.PRNGKey(5)
    feats = rt.cluster_features(params, key, "gradient")
    if feats is None:                          # the sequential loop
        feats = torch.stack([
            TCL.client_gradient_feature(
                adapter.grad, params, *rt.local_data(i), c.size, cfg,
                rng.fold_in(key, i))
            for i, c in enumerate(clients)])
    jgrad = j_adapter(j_smoke(ARCH)).grad
    jkey = jax.random.PRNGKey(5)
    want = np.stack([np.asarray(JCL.client_gradient_feature(
        jgrad, tree, toks[c.train_idx], topics[c.train_idx], c.size,
        JConfig(**KW), jax.random.fold_in(jkey, i)))
        for i, c in enumerate(clients)])
    assert feats.shape == want.shape == (8, 255_472)
    assert float(np.abs(feats.numpy() - want).max()) < FEAT_TOL


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_server_matches_jax(data, jax_run, runtime):
    """The whole loop: stage-1 labels and every round's winners as the
    JAX server's, metrics and final params within tolerance."""
    toks, topics, clients, test = data
    params0, residual0, j_logs, j_clusters, j_params = jax_run
    ts = TServer(FLConfig(**dict(KW, runtime=runtime)),
                 t_adapter(t_smoke(ARCH), "cpu"), toks, topics, clients,
                 test, device="cpu")
    ts.params = interop.flat_params_from_numpy(params0, t_smoke(ARCH),
                                               "cpu")
    ts.state.residual = torch.tensor(residual0)
    t_logs = ts.run()
    np.testing.assert_array_equal(ts.state.clusters.numpy(), j_clusters)
    assert len(t_logs) == len(j_logs) == KW["rounds"]
    for a, b in zip(j_logs, t_logs):
        np.testing.assert_array_equal(b.selected, a.selected)
        for f in ("energy_std", "mean_bid", "vds_gap", "server_reward",
                  "client_reward_sum", "test_loss", "test_acc"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
    assert _max_diff(j_params,
                     interop.flat_params_to_numpy(ts.params)) < PARAMS_TOL
