"""The port's batched runtimes (``vectorized``, ``device``) and cohort
engine against the port's ``sequential`` runtime and the JAX package's
engine, on parameters carried across through numpy, at tests/test_sim.py's
size (N=10, pool 700, J=3, select_ratio 0.4, 2 local epochs, window 10,
T0 2, seed 3).

Tolerances: aggregated params and features within 1e-4 absolute (the
reference's own bound between its runtimes, tests/test_sim.py), since
the vmapped gradients sum in another order than the per-client ones;
selection logs identical."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.core.adapters import cnn_adapter as j_adapter
from repro.core.server import FederatedServer as JServer
from repro.data.partition import ClientData, partition_clients
from repro.data.synthetic import make_image_dataset
from repro.sim.runtime import make_runtime as j_make_runtime
from repro_torch import interop, rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import clustering as TCL
from repro_torch.core.adapters import cnn_adapter as t_adapter
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.launch import train as TRAIN
from repro_torch.optim import apply_updates, sgd
from repro_torch.sim.cohort import pack_feature_pass
from repro_torch.sim.runtime import make_runtime

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

N = 10
TOL = 1e-4
RUNTIMES = ("vectorized", "device")
KW = dict(num_clients=N, num_clusters=3, select_ratio=0.4, rounds=2,
          local_epochs=2, sample_window=10, cluster_resamples=2,
          init_energy_mode="normal", seed=3)


@pytest.fixture(scope="module")
def data():
    train, test = make_image_dataset("mnist", n_train=700, n_test=120,
                                     seed=3)
    clients = partition_clients(train.y, JConfig(**KW), seed=3)
    return train, clients, {"x": test.x[:64], "y": test.y[:64]}


@pytest.fixture(scope="module")
def jparams():
    p = j_adapter("mnist").init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in p.items()}


def _tparams(jparams):
    return interop.params_from_numpy(jparams, "cpu")


def _max_diff(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k]))))
               for k in a)


def _port(cfg_kw, runtime, train, clients, variant="mnist"):
    return make_runtime(FLConfig(**dict(cfg_kw, runtime=runtime)),
                        t_adapter(variant, "cpu"), train.x, train.y,
                        clients, "cpu")


def _zero_size_client() -> ClientData:
    e = np.empty((0,), np.int64)
    return ClientData(train_idx=e, val_idx=e, test_idx=e, primary_label=0)


@pytest.fixture(scope="module")
def jax_vectorized_agg(data, jparams):
    """The JAX VectorizedRuntime's aggregate per aggregator, computed
    once for both port runtimes."""
    train, clients, _ = data
    got = {}

    def agg(aggregator):
        if aggregator not in got:
            rt = j_make_runtime(
                JConfig(**dict(KW, aggregator=aggregator,
                               runtime="vectorized")),
                j_adapter("mnist"), train.x, train.y, clients)
            p = rt.train_cohort(jparams, np.arange(N), np.arange(N) % 3)
            got[aggregator] = {k: np.asarray(v) for k, v in p.items()}
        return got[aggregator]

    return agg


@pytest.mark.parametrize("aggregator", ["fedavg", "fedprox"])
@pytest.mark.parametrize("runtime", RUNTIMES)
def test_train_cohort_matches_sequential_and_jax(data, jparams,
                                                 jax_vectorized_agg,
                                                 runtime, aggregator):
    """Every client, nonzero histories: the batched aggregate agrees with
    the port's sequential one and with the JAX VectorizedRuntime's."""
    train, clients, _ = data
    kw = dict(KW, aggregator=aggregator)
    sel, hist = np.arange(N), np.arange(N) % 3
    params = _tparams(jparams)
    p_seq = _port(kw, "sequential", train, clients).train_cohort(
        params, sel, hist)
    p_eng = _port(kw, runtime, train, clients).train_cohort(params, sel,
                                                            hist)
    assert _max_diff(p_seq, p_eng) < TOL
    assert _max_diff(jax_vectorized_agg(aggregator),
                     interop.params_to_numpy(p_eng)) < TOL


def test_momentum_masks_the_optimizer_state(data, jparams):
    """With momentum the masked steps must leave the momentum buffer
    alone too, or clients with fewer steps drift from the sequential
    run."""
    train, clients, _ = data
    kw = dict(KW, local_momentum=0.9)
    params = _tparams(jparams)
    sel, hist = np.arange(N), np.zeros(N, np.int64)
    p_seq = _port(kw, "sequential", train, clients).train_cohort(
        params, sel, hist)
    for runtime in RUNTIMES:
        p_eng = _port(kw, runtime, train, clients).train_cohort(
            params, sel, hist)
        assert _max_diff(p_seq, p_eng) < TOL, runtime


def test_batchnorm_takes_each_clients_batch_statistics(data):
    """CNN-FMNIST's batch norm under vmap normalizes each client's batch
    by its own statistics, as the sequential loop does."""
    train, clients, _ = data
    params = t_adapter("fmnist", "cpu").init(rng.PRNGKey(1))
    sel, hist = np.arange(4), np.zeros(N, np.int64)
    p_seq = _port(KW, "sequential", train, clients, "fmnist").train_cohort(
        params, sel, hist)
    p_vec = _port(KW, "vectorized", train, clients, "fmnist").train_cohort(
        params, sel, hist)
    assert _max_diff(p_seq, p_vec) < TOL


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_cohort_edge_cases(data, jparams, runtime):
    """The empty cohort and the all-zero-size cohort return None; a
    zero-size winner is dropped and the rest match the sequential run."""
    train, clients, _ = data
    params = _tparams(jparams)
    rt = _port(KW, runtime, train, clients)
    assert rt.train_cohort(params, np.array([], np.int64),
                           np.zeros(N)) is None
    zeros = _port(KW, runtime, train, [_zero_size_client()] * 3)
    assert zeros.train_cohort(params, np.arange(3), np.zeros(3)) is None

    mixed = list(clients)[:4] + [_zero_size_client()]
    kw = dict(KW, num_clients=5)
    hist = np.zeros(5, np.int64)
    seq = _port(kw, "sequential", train, mixed)
    p_ref = seq.train_cohort(params, np.arange(4), hist)
    p_eng = _port(kw, runtime, train, mixed).train_cohort(
        params, np.arange(5), hist)
    assert _max_diff(p_ref, p_eng) < TOL


def test_window_table_matches_per_client_draws(data):
    """The batched stage-1 draws equal the per-client loop's, bit for
    bit (including sizes under the window: draws with replacement)."""
    _, clients, _ = data
    key = rng.PRNGKey(11)
    sizes = torch.tensor([c.size for c in clients] + [3, 1])
    table = TCL.window_index_table(key, sizes, 3, 10)
    for i, n in enumerate(sizes.tolist()):
        ki = rng.fold_in(key, i)
        for t in range(3):
            want = TCL.window_indices(rng.fold_in(ki, t), n, 10, "cpu")
            assert torch.equal(table[i, t], want), (i, t)


def test_gradient_features_match_loop_and_jax(data, jparams):
    train, clients, _ = data
    params = _tparams(jparams)
    cfg = FLConfig(**KW)
    key = rng.PRNGKey(5)
    feats = _port(KW, "vectorized", train, clients).cluster_features(
        params, key, "gradient")
    adapter = t_adapter("mnist", "cpu")
    loop = torch.stack([
        TCL.client_gradient_feature(
            adapter.grad, params, torch.tensor(train.x[c.train_idx]),
            torch.tensor(train.y[c.train_idx]), c.size, cfg,
            rng.fold_in(key, i))
        for i, c in enumerate(clients)])
    assert feats.shape == (N, 21_840)
    assert float((feats - loop).abs().max()) < TOL
    jrt = j_make_runtime(JConfig(**dict(KW, runtime="vectorized")),
                         j_adapter("mnist"), train.x, train.y, clients)
    jfeats = np.asarray(jrt.cluster_features(
        jparams, jax.random.PRNGKey(5), "gradient"))
    assert float(np.abs(jfeats - feats.numpy()).max()) < TOL


def test_weight_features_match_loop_and_jax(data, jparams):
    train, clients, _ = data
    params = _tparams(jparams)
    feats = _port(KW, "vectorized", train, clients).cluster_features(
        params, None, "weights")
    # the reference loop: one in-order epoch of plain SGD per client
    adapter = t_adapter("mnist", "cpu")
    init, update = sgd(KW.get("lr", FLConfig().lr))
    rows = []
    for c in clients:
        x, y = torch.tensor(train.x[c.train_idx]), torch.tensor(
            train.y[c.train_idx])
        p, opt, bs = params, init(params), min(32, c.size)
        for i in range(0, c.size - bs + 1, bs):
            u, opt = update(adapter.grad(p, {"x": x[i:i + bs],
                                             "y": y[i:i + bs]}), opt, p)
            p = apply_updates(p, u)
        rows.append(TCL.flatten_tree({k: p[k] - params[k] for k in p}))
    assert float((feats - torch.stack(rows)).abs().max()) < TOL
    jrt = j_make_runtime(JConfig(**dict(KW, runtime="vectorized")),
                         j_adapter("mnist"), train.x, train.y, clients)
    jfeats = np.asarray(jrt.cluster_features(jparams, None, "weights"))
    assert float(np.abs(jfeats - feats.numpy()).max()) < TOL


def test_weight_features_missing_client_raises(data, jparams):
    train, clients, _ = data
    rt = _port(KW, "vectorized", train, clients)
    buckets = pack_feature_pass(train.x, train.y, clients,
                                chunk_width=rt.cfg.cohort_vmap_width)
    with pytest.raises(ValueError, match="missing from the packed buckets"):
        rt.engine.weight_features(_tparams(jparams), buckets, N + 1)


def test_device_runtime_no_new_shape_after_warmup(data, jparams):
    """Mirrors tests/test_fleet.py's zero-retrace test: after warmup,
    shifting cohorts (one bigger than any tier) meet no new shape."""
    train, clients, _ = data
    params = _tparams(jparams)
    rt = _port(KW, "device", train, clients)
    rt.warmup(params)
    warm = dict(rt.engine.stats)
    assert warm["shape_misses"] == sum(len(c.tiers)
                                       for c in rt.store.classes)
    hist = np.zeros(N, np.int64)
    for sel in (np.arange(N), np.array([0, 3]), np.array([1, 4, 6, 7, 9]),
                np.array([2])):
        assert rt.train_cohort(params, sel, hist) is not None
        hist[sel] += 1
    after = rt.engine.stats
    assert after["shape_misses"] == warm["shape_misses"], (warm, after)
    assert after["shape_hits"] > warm["shape_hits"]


@pytest.fixture(scope="module")
def jax_server_run(data):
    """The JAX sequential server's run per aggregator, made once for both
    port runtimes: (initial params, initial residual, logs, clusters,
    final params), all numpy."""
    train, clients, test_batch = data
    got = {}

    def run(aggregator):
        if aggregator not in got:
            js = JServer(JConfig(**dict(KW, aggregator=aggregator)),
                         j_adapter("mnist"), train.x, train.y, clients,
                         test_batch)
            start = ({k: np.asarray(v) for k, v in js.params.items()},
                     np.asarray(js.state.residual))
            logs = js.run()
            got[aggregator] = start + (
                logs, np.asarray(js.state.clusters),
                {k: np.asarray(v) for k, v in js.params.items()})
        return got[aggregator]

    return run


@pytest.mark.parametrize("aggregator", ["fedavg", "fedprox"])
@pytest.mark.parametrize("runtime", RUNTIMES)
def test_server_matches_jax_sequential(data, jax_server_run, runtime,
                                       aggregator):
    """The whole loop (stage-1 features included) on a batched runtime
    selects what the JAX sequential server selects, every round."""
    train, clients, test_batch = data
    params0, residual0, j_logs, j_clusters, j_params = jax_server_run(
        aggregator)
    ts = TServer(FLConfig(**dict(KW, aggregator=aggregator,
                                 runtime=runtime)),
                 t_adapter("mnist", "cpu"), train.x, train.y, clients,
                 test_batch, device="cpu")
    ts.params = interop.params_from_numpy(params0, "cpu")
    ts.state.residual = torch.tensor(residual0)
    t_logs = ts.run()
    np.testing.assert_array_equal(ts.state.clusters.numpy(), j_clusters)
    assert len(t_logs) == len(j_logs) == KW["rounds"]
    for a, b in zip(j_logs, t_logs):
        np.testing.assert_array_equal(b.selected, a.selected)
        for f in ("energy_std", "mean_bid", "vds_gap", "server_reward",
                  "client_reward_sum"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
    assert _max_diff(j_params, interop.params_to_numpy(ts.params)) < TOL


CLI_SMALL = ["--device", "cpu", "--clients", "8", "--clusters", "2",
             "--rounds", "2", "--pool", "600", "--quiet"]


@pytest.fixture(scope="module")
def cli_sequential():
    return TRAIN.main(CLI_SMALL)


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_cli_runtime_selects_as_sequential(cli_sequential, runtime):
    out = TRAIN.main(CLI_SMALL + ["--runtime", runtime])
    assert out["runtime"] == runtime and out["params_finite"]
    assert out["selected"] == cli_sequential["selected"]
    np.testing.assert_allclose(out["test_loss"], cli_sequential["test_loss"],
                               rtol=1e-4)
