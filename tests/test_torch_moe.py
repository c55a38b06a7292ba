"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the CPU, at granite-moe's smoke width
(d_model 128, 4 experts, top-2, expert d_ff 64) in float32.

The routing is an integer result and is held bit for bit: on the same
router probabilities the port's expert ids, kept flags, buffer slots and
drop fraction are JAX's, ties included.  The JAX side's routing is
``apply_moe``'s own formulas at one group (the JAX package has G = 1
without a mesh).  The layer's output and auxiliary loss are held within
1e-5 of JAX's on shared weights and inputs, and ``vmap(grad)`` through
the layer within 1e-5 of a per-client loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import moe as JMOE
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.models import moe as TMOE

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
CPU = torch.device("cpu")
TOL = 1e-5


def _cfgs(**kw):
    return (JREG.get_smoke_config(ARCH).replace(**kw),
            TREG.get_smoke_config(ARCH).replace(**kw))


def _weights(cfg_j, seed=0):
    p = JMOE.init_moe(jax.random.PRNGKey(seed), cfg_j)
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


def _jax_route(probs, cfg, C):
    """``apply_moe``'s routing lines at G = 1, from (T, E) probs."""
    E, K = cfg.num_experts, cfg.experts_per_token
    gates, idx = jax.lax.top_k(probs, K)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    ranks = jnp.cumsum(onehot, axis=0) - onehot
    rank = jnp.take_along_axis(ranks, flat_e[:, None], axis=1)[:, 0]
    keep = rank < C
    slot = jnp.where(keep, flat_e * C + rank, E * C)
    return [np.asarray(a) for a in (gates, idx, keep, slot)]


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_routing_bit_identical_on_shared_probs(cf):
    """idx, keep, slot and the drop fraction as JAX's; factor 0.5 drops
    many tokens, 8.0 none."""
    cfg_j, cfg_t = _cfgs(moe_capacity_factor=cf)
    pj, pt = _weights(cfg_j)
    x = np.random.default_rng(1).standard_normal((2, 24, cfg_j.d_model)
                                                 ).astype(np.float32)
    T = 48
    C = min(JMOE.moe_capacity(T, cfg_j), T * cfg_j.experts_per_token)
    assert C == min(TMOE.moe_capacity(T, cfg_t), T * 2)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x).reshape(T, -1)
                                      @ pj["router"], axis=-1))
    gates_j, idx_j, keep_j, slot_j = _jax_route(jnp.asarray(probs), cfg_j, C)
    gates, idx, keep, slot, counts = TMOE.route(torch.tensor(probs), cfg_t,
                                                C)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    np.testing.assert_array_equal(slot.numpy(), slot_j)
    np.testing.assert_array_equal(gates.numpy(), gates_j)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(idx_j.reshape(-1), minlength=4))
    _, aux_j = JMOE.apply_moe(pj, jnp.asarray(x), cfg_j)
    _, aux_t = TMOE.apply_moe(pt, torch.tensor(x), cfg_t)
    assert np.float32(aux_t["moe_drop_frac"]) == np.float32(
        aux_j["moe_drop_frac"])
    if cf != 1.25:
        assert (float(aux_t["moe_drop_frac"]) > 0) == (cf < 1.0)


def test_routing_ties_take_the_lower_expert_first():
    """Exact ties: lax.top_k lists the lower index first; so does the
    port (torch.topk promises no order among ties)."""
    cfg_j, cfg_t = _cfgs()
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.2, 0.2, 0.2, 0.4],
                      [0.4, 0.2, 0.2, 0.2]], np.float32)
    _, idx_j, keep_j, slot_j = _jax_route(jnp.asarray(probs), cfg_j, 4)
    _, idx, keep, slot, _ = TMOE.route(torch.tensor(probs), cfg_t, 4)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(idx.numpy()[0], [0, 1])
    np.testing.assert_array_equal(slot.numpy(), slot_j)
    vals, ids = TMOE.top_k(torch.tensor(probs), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("shape", [(2, 1), (2, 24), (1, 33)])
def test_apply_moe_matches_jax(shape, cf):
    """(B, 1) is a decode step's shape (T = B), (B, S) a prefill's: the
    capacity follows the call's token count as in JAX."""
    cfg_j, cfg_t = _cfgs(moe_capacity_factor=cf)
    pj, pt = _weights(cfg_j, 2)
    x = np.random.default_rng(3).standard_normal(
        (*shape, cfg_j.d_model)).astype(np.float32)
    want, aux_j = JMOE.apply_moe(pj, jnp.asarray(x), cfg_j)
    got, aux_t = TMOE.apply_moe(pt, torch.tensor(x), cfg_t)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux_t["moe_aux_loss"]),
                               float(aux_j["moe_aux_loss"]), rtol=TOL)
    assert np.float32(aux_t["moe_drop_frac"]) == np.float32(
        aux_j["moe_drop_frac"])


@pytest.mark.parametrize("tokens", [1, 4, 48, 4096])
def test_capacity_matches_jax(tokens):
    cfg_j, cfg_t = _cfgs()
    full_j = JREG.get_config(ARCH)
    full_t = TREG.get_config(ARCH)
    assert TMOE.moe_capacity(tokens, cfg_t) == JMOE.moe_capacity(tokens,
                                                                cfg_j)
    assert TMOE.moe_capacity(tokens, full_t) == JMOE.moe_capacity(tokens,
                                                                 full_j)


def test_bf16_router_stays_float32():
    """init in bfloat16: the router is float32, the experts bf16; the
    weights carried from JAX keep those types."""
    cfg_j, cfg_t = _cfgs(dtype="bfloat16")
    pt = TMOE.init_moe(torch.tensor([0, 0]), cfg_t, device=CPU)
    assert pt["router"].dtype == torch.float32
    assert pt["w_gate"].dtype == torch.bfloat16
    pj = JMOE.init_moe(jax.random.PRNGKey(0), cfg_j)
    carried = interop.model_params_from_numpy(
        jax.tree.map(np.asarray, pj), cfg_t, CPU)
    assert {k: v.dtype for k, v in carried.items()} == {
        k: v.dtype for k, v in pt.items()}
    np.testing.assert_array_equal(carried["router"].numpy(),
                                  np.asarray(pj["router"]))
    x = torch.randn(2, 5, cfg_t.d_model, generator=torch.Generator(
        ).manual_seed(0)).to(torch.bfloat16)
    out, _ = TMOE.apply_moe(carried, x, cfg_t)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(
        out.float()).all())


def test_vmap_grad_matches_per_client_loop():
    """The batched runtimes' vmap(grad(loss)) through the layer, per
    client's params and tokens, against one grad per client."""
    _, cfg_t = _cfgs(moe_capacity_factor=1.25)
    g = np.random.default_rng(4)
    clients = 3
    params = [TMOE.init_moe(torch.tensor([0, c]), cfg_t, device=CPU)
              for c in range(clients)]
    stacked = {k: torch.stack([p[k] for p in params]) for k in params[0]}
    xs = torch.tensor(g.standard_normal((clients, 2, 12, cfg_t.d_model)
                                        ).astype(np.float32))

    def loss(p, x):
        y, aux = TMOE.apply_moe(p, x, cfg_t)
        return (y * y).mean() + 0.01 * aux["moe_aux_loss"]

    batched = torch.func.vmap(torch.func.grad(loss))(stacked, xs)
    for c in range(clients):
        one = torch.func.grad(loss)(params[c], xs[c])
        for k in one:
            np.testing.assert_allclose(batched[k][c].numpy(),
                                       one[k].numpy(), rtol=TOL, atol=TOL,
                                       err_msg=k)


def _jax_route_grouped(probs, cfg, C):
    """``apply_moe``'s routing lines at G groups, from (G, Tg, E) probs:
    (keep, slot), each (G, Tg*K)."""
    G, Tg, E = probs.shape
    K = cfg.experts_per_token
    _, idx = jax.lax.top_k(probs, K)
    flat_e = idx.reshape(G, Tg * K)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    ranks = jnp.cumsum(onehot, axis=1) - onehot
    rank = jnp.take_along_axis(ranks, flat_e[..., None], axis=2)[..., 0]
    keep = rank < C
    slot = jnp.where(keep, flat_e * C + rank, E * C)
    return np.asarray(keep), np.asarray(slot)


@pytest.mark.parametrize("shape", [(2, 24), (4, 10)])
def test_two_token_groups_match_jax(shape, monkeypatch):
    """G = 2 in both packages (each's ``_num_groups`` patched; under the
    dry run's mesh G is the 'data' axis size): the (G, Tg*K) keep and
    slot are JAX's bit for bit and differ from one group's, each group's
    capacity is moe_capacity(T / 2), and the output and the auxiliary
    losses are JAX's within TOL."""
    cfg_j, cfg_t = _cfgs(moe_capacity_factor=0.5)
    pj, pt = _weights(cfg_j, 5)
    x = np.random.default_rng(6).standard_normal(
        (*shape, cfg_j.d_model)).astype(np.float32)
    T, K = shape[0] * shape[1], cfg_j.experts_per_token
    one_out, _, one_keep, _ = TMOE.moe_forward(pt, torch.tensor(x), cfg_t)
    monkeypatch.setattr(JMOE, "_num_groups", lambda t: 2)
    monkeypatch.setattr(TMOE, "_num_groups", lambda t: 2)
    want, aux_j = JMOE.apply_moe(pj, jnp.asarray(x), cfg_j)
    got, aux_t = TMOE.apply_moe(pt, torch.tensor(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux_t["moe_aux_loss"]),
                               float(aux_j["moe_aux_loss"]), rtol=TOL)
    assert np.float32(aux_t["moe_drop_frac"]) == np.float32(
        aux_j["moe_drop_frac"])
    assert float(aux_t["moe_drop_frac"]) > 0

    C = min(JMOE.moe_capacity(T // 2, cfg_j), T // 2 * K)
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x).reshape(2, T // 2, -1) @ pj["router"], axis=-1))
    keep_j, slot_j = _jax_route_grouped(jnp.asarray(probs), cfg_j, C)
    _, _, keep, slot, counts = TMOE.route(torch.tensor(probs), cfg_t, C)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    np.testing.assert_array_equal(slot.numpy(), slot_j)
    _, probs_t, keep_f, counts_f = TMOE.moe_forward(pt, torch.tensor(x),
                                                    cfg_t)
    assert probs_t.shape == (2, T // 2, cfg_t.num_experts)
    np.testing.assert_array_equal(keep_f.numpy(), keep_j)
    assert torch.equal(counts_f, counts) and int(counts.sum()) == T * K
    # one group ranks over all T tokens: another set is dropped
    assert not np.array_equal(one_keep.numpy(), keep_j.reshape(-1))
    assert not torch.equal(one_out, got)
