"""The port's Byzantine-tolerant path (repro_torch.sim.dynamics' corruption
model, repro_torch.core.aggregation and the runtimes' update programs)
against the JAX package's: the adversary mask bit for bit; every attack
on shared rows (bit for bit; ``noise`` within 1e-5 x scale x rms, as
``rng.normal`` is within about 1e-6 of JAX's; ``sub_clip`` within 1e-6
relative, as its scale is an l2 norm XLA sums in its vectoriser's
order); the screened step under
every defense x {static, adaptive} x watchdog {off, on} over three chained
rounds and with rows on both sides of the adaptive band's edge (strikes,
hence the quarantine and band verdicts, bit for bit;
``agg`` within 1e-6, bit for bit for trimmed and median; the report's
counts exact and its floats within 1e-6 relative); the flat-delta layout;
``train_cohort_updates`` on each runtime within 1e-4 of the JAX runtime's;
defended servers against the JAX server (``trimmed`` + ``scale`` and
``adaptive`` + ``price`` + ``sub_clip``: winners, strikes and totals bit
for bit, params within 1e-4); and the JAX package's invariants (defense
knobs off, frac 0, the scan path at zero strikes, the device runtime's
warm loop meeting no new shape).  Fixtures at tests/test_robust.py's size
(N=10, pool 700, J=3, 3 rounds, seed 3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as JOBS
from repro.configs.base import FLConfig as JConfig
from repro.core import aggregation as JAGG
from repro.core import rounds as JRND
from repro.core.adapters import cnn_adapter as j_adapter
from repro.core.server import FederatedServer as JServer
from repro.data.partition import partition_clients
from repro.data.synthetic import make_image_dataset
from repro.sim import dynamics as JDYN
from repro.sim.runtime import make_runtime as j_make_runtime
from repro_torch import interop, obs, rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import aggregation as TAGG
from repro_torch.core import rounds as TRND
from repro_torch.core.adapters import cnn_adapter
from repro_torch.core.server import FederatedServer
from repro_torch.sim import dynamics as TDYN
from repro_torch.sim.runtime import make_runtime

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

RUNTIMES = ("sequential", "vectorized", "device")
KW = dict(num_clients=10, num_clusters=3, select_ratio=0.4, rounds=3,
          local_epochs=1, sample_window=10, cluster_resamples=2,
          init_energy_mode="normal", seed=3)
TRIMMED = dict(adversary_frac=0.3, attack="scale", defense="trimmed")
SELFHEAL = dict(adversary_frac=0.3, attack="sub_clip", defense="clip",
                defense_mode="adaptive", reputation_mode="price")


@pytest.fixture(autouse=True)
def _obs_reset():
    obs.OBS.reset()
    JOBS.OBS.reset()
    yield
    obs.OBS.reset()
    JOBS.OBS.reset()


@pytest.fixture(scope="module")
def data():
    train, test = make_image_dataset("mnist", n_train=700, n_test=120,
                                     seed=3)
    clients = partition_clients(train.y, JConfig(**KW), seed=3)
    return train, clients, {"x": test.x[:64], "y": test.y[:64]}


def _server(data, **kw):
    train, clients, test_batch = data
    return FederatedServer(FLConfig(**dict(KW, **kw)),
                           cnn_adapter("mnist", "cpu"), train.x, train.y,
                           clients, test_batch, device="cpu")


def _jserver(data, **kw):
    train, clients, test_batch = data
    return JServer(JConfig(**dict(KW, **kw)), j_adapter("mnist"), train.x,
                   train.y, clients, test_batch)


def _assert_params_equal(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ----------------------------------------------------------------------
# the corruption model
# ----------------------------------------------------------------------

def test_constants_keys_and_capacity_match_jax():
    assert TDYN.ATTACKS == JDYN.ATTACKS
    assert TAGG.DEFENSES == JAGG.DEFENSES
    assert TAGG.DEFENSE_MODES == JAGG.DEFENSE_MODES
    for seed in (0, 3, 12):
        np.testing.assert_array_equal(
            TDYN.adversary_key(FLConfig(seed=seed)).numpy(),
            np.asarray(JDYN.adversary_key(JConfig(seed=seed))))
    for kw in (KW, dict(num_clients=32, num_clusters=4, select_ratio=0.3),
               dict(num_clients=100), dict(num_clients=7, scheme="random"),
               dict(num_clients=1000, num_clusters=3, select_ratio=0.02)):
        assert TAGG.screen_capacity(FLConfig(**kw)) == \
            JAGG.screen_capacity(JConfig(**kw))


@pytest.mark.parametrize("n,frac,seed", [(10, 0.3, 3), (10, 0.3, 4),
                                         (32, 0.3, 0), (100, 0.1, 7),
                                         (2000, 0.25, 1), (10, 0.0, 3),
                                         (5, 1.0, 2)])
def test_adversary_mask_matches_jax(n, frac, seed):
    kw = dict(num_clients=n, adversary_frac=frac, attack="nan", seed=seed)
    want = np.asarray(JDYN.adversary_mask(JConfig(**kw)))
    got = TDYN.adversary_mask(FLConfig(**kw), "cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() == round(frac * n)


def _rows(seed=0, c=8, d=333):
    r = np.random.default_rng(seed)
    deltas = (r.normal(size=(c, d))
              * r.uniform(0.5, 2.0, (c, 1))).astype(np.float32)
    adv = np.arange(c) % 3 == 0
    valid = np.ones(c, bool)
    valid[[4, c - 1]] = False          # row c-1 adversarial and invalid
    return deltas, adv, valid


_jit_corrupt = jax.jit(JDYN.corrupt_updates, static_argnums=0)


@pytest.mark.parametrize("attack", JDYN.ATTACKS)
def test_corrupt_updates_matches_jax(attack):
    kw = dict(num_clients=10, adversary_frac=0.3, attack=attack,
              attack_scale=5.0)
    jcfg, tcfg = JConfig(**kw), FLConfig(**kw)
    deltas, adv, valid = _rows()
    hit = adv & valid
    for ce, rnd in ((0.0, 0), (1.7, 2), (25.0, 5)):
        want = np.asarray(_jit_corrupt(
            jcfg, jax.random.PRNGKey(rnd), jnp.asarray(deltas),
            jnp.asarray(adv), jnp.asarray(valid), jnp.float32(ce),
            jnp.int32(rnd)))
        got = TDYN.corrupt_updates(
            tcfg, rng.PRNGKey(rnd), torch.tensor(deltas), torch.tensor(adv),
            torch.tensor(valid), clip_ema=torch.tensor(ce),
            round_idx=torch.tensor(rnd, dtype=torch.int32)).numpy()
        # honest and padding rows pass through unchanged
        np.testing.assert_array_equal(got[~hit], deltas[~hit])
        if attack == "noise":
            rms = float(np.sqrt(np.square(deltas[valid]).mean()))
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * 5.0 * rms)
            assert (got[hit] != deltas[hit]).any()
        elif attack == "sub_clip":
            # the row's scale comes from l2 norms over D, summed in the
            # order XLA's CPU vectoriser picks (not a plain loop), so it
            # agrees to an ulp or two rather than bit for bit
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want)
        if attack == "none":
            np.testing.assert_array_equal(got, deltas)


def test_corrupt_updates_identity_when_inactive():
    deltas, adv, valid = _rows(1)
    for kw in ({}, dict(attack="scale"), dict(adversary_frac=0.3)):
        out = TDYN.corrupt_updates(FLConfig(**kw), rng.PRNGKey(7),
                                   torch.tensor(deltas), torch.tensor(adv),
                                   torch.tensor(valid))
        np.testing.assert_array_equal(out.numpy(), deltas)


def test_column_sum_and_sqrt32_round_as_xla():
    r = np.random.default_rng(5)
    for c, d in ((1, 7), (8, 333), (16, 4000)):
        x = r.normal(size=(c, d)).astype(np.float32)
        want = np.asarray(jax.jit(lambda a: a.sum(0))(jnp.asarray(x)))
        np.testing.assert_array_equal(
            TDYN.column_sum(torch.tensor(x)).numpy(), want)
    v = r.uniform(0, 50, 100_000).astype(np.float32)
    np.testing.assert_array_equal(TDYN.sqrt32(torch.tensor(v)).numpy(),
                                  np.sqrt(v))


# ----------------------------------------------------------------------
# the screened step
# ----------------------------------------------------------------------

N_SCREEN = 20
_REPORT_COUNTS = ("num_quarantined", "num_screened", "num_survivors")


def _screen_inputs(seed, cap=16, d=500):
    r = np.random.default_rng(seed)
    deltas = (r.normal(size=(cap, d))
              * r.uniform(0.5, 1.5, (cap, 1))).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[:12] = True
    deltas[~valid] = deltas[0]         # padding gathers row 0
    deltas[3] = np.nan                 # quarantined
    deltas[7, 5] = np.inf
    w = np.where(valid, r.uniform(0.1, 1.0, cap), 0.0).astype(np.float32)
    w /= w.sum()
    adv = valid & (np.arange(cap) % 4 == 1)   # scaled: band outliers
    ids = np.where(valid, r.permutation(N_SCREEN)[:cap], -1).astype(np.int32)
    strikes = r.uniform(0.0, 1.0, N_SCREEN).astype(np.float32)
    return deltas, w, valid, adv, ids, strikes


@pytest.mark.parametrize("watchdog", ["off", "on"])
@pytest.mark.parametrize("mode", TAGG.DEFENSE_MODES)
@pytest.mark.parametrize("defense", TAGG.DEFENSES)
def test_screened_step_matches_jax(defense, mode, watchdog):
    kw = dict(num_clients=N_SCREEN, defense=defense, defense_mode=mode,
              watchdog=watchdog, adversary_frac=0.3, attack="scale",
              attack_scale=4.0)
    jcfg, tcfg = JConfig(**kw), FLConfig(**kw)
    jstep = JAGG.make_screened_step(jcfg)
    tstep = TAGG.make_screened_step(tcfg)
    jds = JAGG.init_defense_state(jcfg)
    tds = TAGG.init_defense_state(tcfg, "cpu")
    if watchdog == "on":              # a tightened band, as after a rollback
        jds = dataclasses.replace(jds, tighten=jnp.float32(1.5))
        tds = dataclasses.replace(tds, tighten=torch.tensor(1.5))
    screened = 0
    for rnd in range(3):               # chained: the EMAs seed, then move
        d, w, v, adv, ids, strikes = _screen_inputs(rnd)
        jagg, jst, jds, jrep = jstep(
            jnp.asarray(d), jnp.asarray(w), jnp.asarray(v), jnp.asarray(adv),
            jnp.asarray(ids), jnp.asarray(strikes), jds, jnp.int32(rnd),
            jax.random.PRNGKey(rnd))
        tagg, tst, tds, trep = tstep(
            *map(torch.tensor, (d, w, v, adv, ids, strikes)), tds,
            torch.tensor(rnd, dtype=torch.int32), rng.PRNGKey(rnd))
        # ids are distinct, so the strikes carry every row's quarantine
        # (+1) and band (+outlier_strike) verdict
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        assert not np.shares_memory(tst.numpy(), strikes)
        jagg = np.asarray(jagg)
        if defense in ("trimmed", "median"):
            np.testing.assert_array_equal(tagg.numpy(), jagg)
        elif defense == "none":        # the NaN row flows into the sum
            assert np.isnan(jagg).all() and np.isnan(tagg.numpy()).all()
        else:
            np.testing.assert_allclose(tagg.numpy(), jagg, rtol=0,
                                       atol=1e-6)
        assert sorted(trep) == sorted(jrep)
        for k in jrep:
            if k in _REPORT_COUNTS:
                assert int(trep[k]) == int(jrep[k]), k
            else:
                np.testing.assert_allclose(float(trep[k]), float(jrep[k]),
                                           rtol=1e-6, atol=0, err_msg=k)
        for f in ("clip_ema", "mad_ema", "pressure", "tighten"):
            a, b = getattr(tds, f), getattr(jds, f)
            assert (a is None) == (b is None), f
            if b is not None:
                np.testing.assert_allclose(float(a), float(b), rtol=1e-6,
                                           err_msg=f)
        screened += int(trep["num_screened"])
        if defense != "none":
            assert int(trep["num_quarantined"]) == 2
    assert (screened > 0) == (mode == "adaptive" and defense != "none")


# offsets of rows from the adaptive band's edge: far above float noise
# (1e-7), close enough that a band a few per cent off moves some verdict
_EDGE = (-0.1, -0.05, -0.02, -0.01, -0.005, -0.002, -0.001,
         0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2)


@pytest.mark.parametrize("pressure,tighten", [(0.0, None), (0.5, None),
                                              (0.0, 1.5), (0.25, 1.5)])
def test_screened_step_band_edge_matches_jax(pressure, tighten):
    """Rows on both sides of the adaptive band's edge: 17 equal rows make
    the median norm n0 and the MAD 0, so the edge is n0 (1 + k_eff
    floor), k_eff = adapt_k / (1 + gain pressure) / tighten; a row of
    norm n0 s (1 + e) is screened exactly when e > 0, in both packages."""
    kw = dict(num_clients=40, defense="clip", defense_mode="adaptive",
              watchdog="on" if tighten else "off", adversary_frac=0.3,
              attack="sub_clip")
    jcfg, tcfg = JConfig(**kw), FLConfig(**kw)
    k_eff = tcfg.adapt_k / (1.0 + tcfg.adapt_gain * pressure) / (tighten or 1)
    edge = 1.0 + k_eff * tcfg.adapt_mad_floor
    r = np.random.default_rng(5)
    u = r.normal(size=64)
    u /= np.linalg.norm(u)
    scale = np.r_[np.ones(17), edge * (1.0 + np.asarray(_EDGE))]
    d = (scale[:, None] * u[None, :]).astype(np.float32)
    cap = d.shape[0]
    w = np.full(cap, 1.0 / cap, np.float32)
    valid, adv = np.ones(cap, bool), np.zeros(cap, bool)
    ids = r.permutation(40)[:cap].astype(np.int32)
    strikes = np.zeros(40, np.float32)
    jds = JAGG.init_defense_state(jcfg)
    tds = TAGG.init_defense_state(tcfg, "cpu")
    jds = dataclasses.replace(jds, pressure=jnp.float32(pressure))
    tds = dataclasses.replace(tds, pressure=torch.tensor(pressure,
                                                         dtype=torch.float32))
    if tighten:
        jds = dataclasses.replace(jds, tighten=jnp.float32(tighten))
        tds = dataclasses.replace(tds, tighten=torch.tensor(
            tighten, dtype=torch.float32))
    _, jst, _, jrep = JAGG.make_screened_step(jcfg)(
        jnp.asarray(d), jnp.asarray(w), jnp.asarray(valid), jnp.asarray(adv),
        jnp.asarray(ids), jnp.asarray(strikes), jds, jnp.int32(0),
        jax.random.PRNGKey(0))
    _, tst, _, trep = TAGG.make_screened_step(tcfg)(
        *map(torch.tensor, (d, w, valid, adv, ids, strikes)), tds,
        torch.tensor(0, dtype=torch.int32), rng.PRNGKey(0))
    above = int((np.asarray(_EDGE) > 0).sum())
    assert int(jrep["num_screened"]) == int(trep["num_screened"]) == above
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    screened = np.zeros(40, bool)
    screened[ids[17:][np.asarray(_EDGE) > 0]] = True
    np.testing.assert_array_equal(tst.numpy() > 0, screened)


def test_flat_delta_and_apply_delta_layout_match_jax():
    p = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in
         j_adapter("mnist").init(jax.random.PRNGKey(0)).items()}, "cpu")
    q = {k: v + 0.25 * torch.ones_like(v) * (i + 1)
         for i, (k, v) in enumerate(sorted(p.items()))}
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    jq = {k: jnp.asarray(v.numpy()) for k, v in q.items()}
    want = np.asarray(JAGG.make_flat_delta(jp)(jq, jp))
    got = TAGG.flat_delta(q, p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert TAGG.flat_size(p) == JAGG.flat_size(jp) == got.numel() == 21840
    back = TAGG.apply_delta(p, got)
    jback = JAGG.make_apply_delta(jp)(jp, jnp.asarray(want))
    for k in p:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))


# ----------------------------------------------------------------------
# the runtimes' update programs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("runtime", RUNTIMES)
def test_train_cohort_updates_matches_jax_runtime(data, runtime):
    train, clients, _ = data
    cfg = dict(KW, runtime=runtime, **TRIMMED)
    jparams = j_adapter("mnist").init(jax.random.PRNGKey(1))
    tparams = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    jrt = j_make_runtime(JConfig(**cfg), j_adapter("mnist"), train.x,
                         train.y, clients)
    trt = make_runtime(FLConfig(**cfg), cnn_adapter("mnist", "cpu"),
                       train.x, train.y, clients, "cpu")
    if runtime == "device":
        trt.warmup(tparams)
    history = np.arange(10) % 3
    sel = np.array([0, 2, 5, 6, 9])
    want = jrt.train_cohort_updates(jparams, sel, history)
    got = trt.train_cohort_updates(tparams, sel, history)
    np.testing.assert_array_equal(got.client_idx, want.client_idx)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.deltas.dtype == torch.float32
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas),
                               rtol=1e-4, atol=1e-4)
    pad = got.client_idx < 0
    assert not got.deltas[torch.from_numpy(pad)].any()
    assert trt.train_cohort_updates(tparams, np.array([], np.int64),
                                    history) is None


# ----------------------------------------------------------------------
# defended servers against the JAX server
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(data):
    out = {}
    for name, kw in (("trimmed", TRIMMED), ("selfheal", SELFHEAL)):
        JOBS.OBS.reset()
        srv = _jserver(data, **kw)
        srv.run()
        out[name] = srv
    JOBS.OBS.reset()
    return out


@pytest.mark.parametrize("runtime", RUNTIMES)
@pytest.mark.parametrize("case", ["trimmed", "selfheal"])
def test_defended_server_matches_jax_server(data, jax_runs, case, runtime):
    kw = TRIMMED if case == "trimmed" else SELFHEAL
    ref = jax_runs[case]
    srv = _server(data, runtime=runtime, **kw)
    logs = srv.run()
    assert [l.selected.tolist() for l in logs] == \
        [l.selected.tolist() for l in ref.logs]
    np.testing.assert_array_equal(srv.state.strikes.numpy(),
                                  np.asarray(ref.state.strikes))
    assert srv.defense_totals == ref.defense_totals
    np.testing.assert_array_equal(srv._adv_mask, ref._adv_mask)
    for k, v in ref.params.items():
        np.testing.assert_allclose(srv.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for a, b in zip(logs, ref.logs):
        np.testing.assert_allclose(a.test_loss, b.test_loss, rtol=1e-4)
    if case == "selfheal":
        assert srv.defense_totals["screened"] > 0


# ----------------------------------------------------------------------
# the JAX package's invariants, on the port
# ----------------------------------------------------------------------

@pytest.mark.parametrize("runtime", RUNTIMES)
def test_defense_knobs_off_bit_identical(data, runtime):
    plain = _server(data, runtime=runtime, rounds=2)
    logs_p = plain.run()
    knobs = _server(data, runtime=runtime, rounds=2, adversary_frac=0.0,
                    attack="scale", attack_scale=9.0, defense="none",
                    defense_mode="adaptive")
    assert not knobs.defended
    logs_k = knobs.run()
    _assert_params_equal(plain.params, knobs.params)
    for a, b in zip(logs_p, logs_k):
        np.testing.assert_array_equal(a.selected, b.selected)
        assert a.mean_bid == b.mean_bid
    assert knobs.state.strikes is None


@pytest.mark.parametrize("runtime", RUNTIMES)
@pytest.mark.parametrize("rep_mode", ["ban", "price"])
def test_frac0_trust_constant_and_selection_identical(data, runtime,
                                                      rep_mode):
    plain = _server(data, runtime=runtime)
    logs_p = plain.run()
    srv = _server(data, runtime=runtime, adversary_frac=0.0,
                  defense="median", reputation_mode=rep_mode)
    assert srv.defended
    mem = obs.configure(memory=True)
    logs_d = srv.run()
    assert not srv.state.strikes.any()
    for a, b in zip(logs_p, logs_d):
        np.testing.assert_array_equal(a.selected, b.selected)
        assert a.mean_bid == b.mean_bid
    rows = [e for e in mem.events if e["kind"] == "round"]
    assert rows and all(r["trust_min"] == 1.0 for r in rows)


@pytest.mark.parametrize("rep_mode", ["ban", "price"])
def test_frac0_scan_path_identical(rep_mode):
    cfg = FLConfig(**dict(KW, num_clients=64, num_clusters=4,
                          reputation_mode=rep_mode))
    key = rng.PRNGKey(11)
    state0 = TRND.synthetic_fleet(cfg, key, device="cpu")
    kr = rng.fold_in(key, 1)
    _, m_plain, w_plain = TRND.simulate_rounds(state0, cfg, kr, 5,
                                               record_wins=True)
    state_s = dataclasses.replace(
        state0, strikes=torch.zeros(cfg.num_clients))
    final, m_def, w_def = TRND.simulate_rounds(state_s, cfg, kr, 5,
                                               record_wins=True)
    assert torch.equal(w_plain, w_def)
    assert torch.equal(m_plain["mean_bid"], m_def["mean_bid"])
    assert float(m_def["trust_min"].min()) == 1.0
    assert not final.strikes.any()
    # and the JAX scan path, on the same fleet, picks the same winners
    jcfg = JConfig(**dict(KW, num_clients=64, num_clusters=4,
                          reputation_mode=rep_mode))
    jstate = JRND.synthetic_fleet(jcfg, jax.random.PRNGKey(11))
    jstate = dataclasses.replace(
        jstate, strikes=jnp.zeros((64,), jnp.float32))
    _, _, jw = JRND.simulate_rounds(jstate, jcfg, jax.random.fold_in(
        jax.random.PRNGKey(11), 1), 5, record_wins=True)
    np.testing.assert_array_equal(w_def.numpy(), np.asarray(jw))


def test_nan_attack_quarantine_equivalent_across_runtimes(data):
    outs = {}
    for rt in RUNTIMES:
        srv = _server(data, runtime=rt, adversary_frac=0.3, attack="nan",
                      defense="median")
        logs = srv.run()
        assert all(torch.isfinite(v).all() for v in srv.params.values())
        outs[rt] = (srv.state.strikes.numpy(),
                    [l.selected.tolist() for l in logs],
                    srv.defense_totals["quarantined"])
    ref = outs["sequential"]
    assert ref[2] > 0
    for rt in RUNTIMES[1:]:
        np.testing.assert_array_equal(outs[rt][0], ref[0])
        assert outs[rt][1:] == ref[1:]


def test_device_defended_warm_loop_meets_no_new_shape(data):
    srv = _server(data, runtime="device", rounds=8, **TRIMMED)
    srv.run(rounds=3)
    stats = srv.runtime.engine.stats
    shapes = sum(len(c.tiers) for c in srv.runtime.store.classes)
    assert stats["shape_misses"] == shapes
    for t in range(3, 8):               # shifting cohorts, warm
        srv._dispatch_round(t, eval_now=False)
    srv._flush_pending()
    assert stats["shape_misses"] == shapes
    assert all(k[0] == "class_upd" for k in srv.runtime.engine._seen_shapes)
