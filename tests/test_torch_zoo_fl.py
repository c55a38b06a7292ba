"""Transformer FL over the MoE and xLSTM archs in the port against the
JAX package, on the CPU, at tests/test_torch_transformer_fl.py's size (8
clients, 2 clusters, 2 rounds, sequences of 16 tokens): the whole loop
on ``sequential``, ``vectorized`` and ``device`` for granite-moe-3b-
a800m's and xlstm-1.3b's smoke configs, from the JAX server's initial
params and energies (carried across through numpy).  The batched
runtimes run ``vmap(grad(loss))`` through the MoE dispatch and the
sLSTM/mLSTM recurrences.

Tolerances as tests/test_torch_transformer_fl.py: cluster labels and
every round's winners identical; round metrics within 1e-5; final params
within 1e-4.  Jamba's JAX FL run takes a minute of this CPU; its blocks
are held by tests/test_torch_mamba.py and tests/test_torch_zoo.py."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core.adapters import transformer_adapter as j_adapter
from repro.core.server import FederatedServer as JServer
from repro.data.partition import partition_clients
from repro.data.synthetic import make_token_dataset
from repro_torch import interop
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.core.adapters import transformer_adapter as t_adapter
from repro_torch.core.server import FederatedServer as TServer

torch.set_num_threads(1)

ARCHS = ("granite-moe-3b-a800m", "xlstm-1.3b")
KW = dict(num_clients=8, num_clusters=2, select_ratio=0.25, rounds=2,
          lr=0.1, non_iid_level=1.0, scheme="gradient_cluster_auction",
          num_classes=4, sample_window=6, cluster_resamples=2)
RUNTIMES = ("sequential", "vectorized", "device")
PARAMS_TOL = 1e-4


@pytest.fixture(scope="module")
def data():
    toks, topics = make_token_dataset(num_topics=4, vocab=256, seq_len=16,
                                      n=240, seed=0)
    clients = partition_clients(topics, JConfig(**KW), seed=0)
    return toks, topics, clients, {"x": toks[:32], "y": topics[:32]}


_JAX_RUNS = {}


def _jax_run(data, arch):
    """The JAX sequential server: (initial params tree, initial residual,
    logs, cluster labels, final params tree), numpy."""
    if arch not in _JAX_RUNS:
        toks, topics, clients, test = data
        js = JServer(JConfig(**KW), j_adapter(j_smoke(arch)), toks, topics,
                     clients, test)
        start = (jax.tree.map(np.asarray, js.params),
                 np.asarray(js.state.residual))
        logs = js.run()
        _JAX_RUNS[arch] = start + (logs, np.asarray(js.state.clusters),
                                   jax.tree.map(np.asarray, js.params))
    return _JAX_RUNS[arch]


def _max_diff(a, b) -> float:
    return max(float(np.abs(x - y).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@pytest.mark.parametrize("runtime", RUNTIMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_jax(data, arch, runtime):
    toks, topics, clients, test = data
    params0, residual0, j_logs, j_clusters, j_params = _jax_run(data, arch)
    ts = TServer(FLConfig(**dict(KW, runtime=runtime)),
                 t_adapter(t_smoke(arch), "cpu"), toks, topics, clients,
                 test, device="cpu")
    ts.params = interop.flat_params_from_numpy(params0, t_smoke(arch),
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
