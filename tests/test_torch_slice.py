"""The whole slice: the port's FederatedServer against the JAX sequential
server at tests/test_sim.py's size (N=10, pool 700, J=3, select_ratio
0.4, 2 rounds, 2 local epochs, seed 3); the port's CLI in-process, and
against the JAX CLI at its defaults for 3 rounds; and the cuda default of
every public constructor."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.core.adapters import cnn_adapter as j_adapter
from repro.core.server import FederatedServer as JServer
from repro.data.partition import partition_clients
from repro.data.synthetic import make_image_dataset
from repro_torch import interop, rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import energy as TE
from repro_torch.core import rounds as TRND
from repro_torch.core import schemes as TSCH
from repro_torch.core.adapters import cnn_adapter as t_adapter
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.data import synthetic as TSYN
from repro_torch.launch import train as TRAIN
from repro_torch.models import cnn as TCNN
from repro_torch.models import layers as TLAYERS
from repro_torch.sim.fleet import FleetStore
from repro_torch.sim.runtime import make_runtime

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

KW = dict(num_clients=10, num_clusters=3, select_ratio=0.4, rounds=2,
          local_epochs=2, sample_window=10, cluster_resamples=2,
          init_energy_mode="normal", seed=3)


@pytest.fixture(scope="module")
def data():
    train, test = make_image_dataset("mnist", n_train=700, n_test=120,
                                     seed=3)
    clients = partition_clients(train.y, JConfig(**KW), seed=3)
    return train, clients, {"x": test.x[:64], "y": test.y[:64]}


@pytest.mark.parametrize("extra", [{}, {"aggregator": "fedprox"},
                                   {"local_momentum": 0.9}],
                         ids=["fedavg", "fedprox", "momentum"])
def test_server_matches_jax_sequential(data, extra):
    train, clients, test_batch = data
    kw = dict(KW, **extra)
    js = JServer(JConfig(**kw), j_adapter("mnist"), train.x, train.y,
                 clients, test_batch)
    ts = TServer(FLConfig(**kw), t_adapter("mnist", "cpu"), train.x, train.y,
                 clients, test_batch, device="cpu")
    # start from the JAX server's exact parameters and energy
    ts.params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in js.params.items()}, "cpu")
    ts.state.residual = torch.tensor(np.asarray(js.state.residual))
    j_logs, t_logs = js.run(), ts.run()

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


def test_launch_main_cpu_prints_final_line(capsys):
    out = TRAIN.main(["--device", "cpu", "--clients", "12", "--clusters",
                      "3", "--rounds", "2", "--pool", "1200", "--quiet"])
    assert len(out["test_acc"]) == 2 and np.isfinite(out["test_acc"][-1])
    assert out["device"] == "cpu"
    assert "final acc=" in capsys.readouterr().out


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRAIN.main(["--clients", "12", "--clusters", "3", "--rounds", "1",
                    "--pool", "1200", "--quiet"])


# every public constructor, called without a device, asks for cuda
DEFAULT_DEVICE_CALLS = {
    "FederatedServer": lambda d: TServer(
        FLConfig(**KW), t_adapter("mnist", "cpu"), d[0].x, d[0].y, d[1],
        d[2]),
    "cnn_adapter": lambda d: t_adapter("mnist"),
    "make_image_dataset": lambda d: TSYN.make_image_dataset(
        "mnist", n_train=12, n_test=6),
    "make_runtime": lambda d: make_runtime(
        FLConfig(**KW), t_adapter("mnist", "cpu"), d[0].x, d[0].y, d[1]),
    "make_runtime(vectorized)": lambda d: make_runtime(
        FLConfig(**KW, runtime="vectorized"), t_adapter("mnist", "cpu"),
        d[0].x, d[0].y, d[1]),
    "make_runtime(device)": lambda d: make_runtime(
        FLConfig(**KW, runtime="device"), t_adapter("mnist", "cpu"),
        d[0].x, d[0].y, d[1]),
    "FleetStore": lambda d: FleetStore(d[0].x, d[0].y, d[1],
                                       FLConfig(**KW)),
    "init_energy": lambda d: TE.init_energy(FLConfig(**KW), rng.PRNGKey(0)),
    "make_round_step": lambda d: TRND.make_round_step(FLConfig(**KW)),
    "init_cnn": lambda d: TCNN.init_cnn(rng.PRNGKey(0), "mnist"),
    "params_from_numpy": lambda d: interop.params_from_numpy(
        {"c1_b": np.zeros(6, np.float32)}),
    "rng.uniform": lambda d: rng.uniform(rng.PRNGKey(0), (3,)),
    "rng.permutation": lambda d: rng.permutation(rng.PRNGKey(0), 5),
    "rng.choice": lambda d: rng.choice(rng.PRNGKey(0), 5, (2,),
                                       replace=False),
    "synthetic_fleet": lambda d: TRND.synthetic_fleet(FLConfig(**KW),
                                                      rng.PRNGKey(0)),
    "init_scheme_state": lambda d: TSCH.init_scheme_state(
        FLConfig(**KW, scheme_select="longterm_auction")),
    "rope_freqs": lambda d: TLAYERS.rope_freqs(64, 10_000.0),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CALLS))
def test_default_device_is_cuda_and_raises_without_gpu(data, monkeypatch,
                                                       name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULT_DEVICE_CALLS[name](data)


# The winners the JAX package picks with the CLI's defaults (100 clients,
# 10 clusters, pool 12,000, MNIST CNN, seed 0) in rounds 0-2: the s_min
# sample threshold and the energy gate leave some clusters without an
# eligible bidder.  chip_smoke.py holds the GPU run to the same sets.
DEFAULT_WINNERS = [[1, 35, 40], [12, 35, 36, 41, 49, 58, 60, 63],
                   [0, 1, 3, 19, 35, 36, 44, 58, 62]]


def test_cli_defaults_match_jax_cli(monkeypatch):
    import repro.launch.train as JTRAIN

    servers = []

    class Recording(JTRAIN.FederatedServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    monkeypatch.setattr(JTRAIN, "FederatedServer", Recording)
    monkeypatch.setattr("sys.argv", ["train", "--mode", "paper",
                                     "--rounds", "3", "--quiet"])
    JTRAIN.main()
    j_logs = servers[0].logs
    t = TRAIN.main(["--device", "cpu", "--rounds", "3", "--quiet"])
    assert [l.selected.tolist() for l in j_logs] == DEFAULT_WINNERS
    assert t["selected"] == DEFAULT_WINNERS
    for f in ("energy_std", "mean_bid", "vds_gap", "server_reward",
              "client_reward_sum", "test_acc", "test_loss"):
        np.testing.assert_allclose(t[f], [getattr(l, f) for l in j_logs],
                                   rtol=1e-5, atol=1e-5, err_msg=f)


SMALL = ["--clients", "12", "--clusters", "3", "--rounds", "1", "--pool",
         "1200", "--quiet"]


@pytest.mark.parametrize("flag", [["--runtime", "sharded"],
                                  ["--mode", "transformer", "--arch",
                                   "qwen3-moe-235b-a22b"],
                                  ["--cohort-devices", "2"]])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError):
        TRAIN.main(["--device", "cpu", *SMALL, *flag])


def _summary_lines(text):
    return [l for l in text.splitlines()
            if l.startswith(("defense ", "watchdog: "))]


# flags that raised before the Byzantine path was ported: each now runs
# for a round and closes with the JAX CLI's defense / watchdog lines
@pytest.mark.parametrize("flag", [["--defense-mode", "adaptive"],
                                  ["--defense", "clip"],
                                  ["--watchdog", "on"],
                                  ["--reputation-mode", "price"],
                                  ["--adversary-frac", "0.1"]])
def test_byzantine_flags_match_jax_cli_summary(flag, monkeypatch, capsys):
    import repro.launch.train as JTRAIN
    monkeypatch.setattr("sys.argv", ["train", *SMALL, *flag])
    JTRAIN.main()
    want = _summary_lines(capsys.readouterr().out)
    out = TRAIN.main(["--device", "cpu", *SMALL, *flag])
    got = _summary_lines(capsys.readouterr().out)
    assert got == want
    assert len(out["test_acc"]) == 1
    assert ("defense" in out) == any(l.startswith("defense ") for l in want)
    if flag[0] in ("--defense", "--watchdog"):
        assert got
