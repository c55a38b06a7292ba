"""phi-3-vision's bfloat16 teacher-forced decode against its prefix-free
forward, in the port and in the JAX package, on the CPU: chip_smoke.py's
vlm reading (the worst |decode - forward| over the decoded positions
divided by the forward's largest |logit|) over 64 positions of the
smoke config in bfloat16, the JAX weights carried across by ``interop``.

The port's reading may exceed the JAX package's by at most RATIO: at
full width on the CPU (``tools/vlm_bf16_witness.py``, 2 and 4 layers)
the port read 1.23x and 1.03x the JAX package's, and the card 0.98x and
1.09x.  The reading counts bfloat16 rounding steps of the logits, so a
decode path that rounds more than the reference's shows as a larger
step count.  Each package's decode and forward are also held to the
other's within LOGITS_REL_TOL."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import model as JMD
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.models import model as TMD

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

ARCH = "phi-3-vision-4.2b"
STEPS = 64
RATIO = 1.25
LOGITS_REL_TOL = 2e-2        # chip_smoke.py's


def reading(dec: np.ndarray, full: np.ndarray) -> float:
    return float(np.abs(dec - full).max() / np.abs(full).max())


@pytest.fixture(scope="module", params=[0, 1, 2], ids=lambda s: f"key{s}")
def logits(request):
    """(JAX forward, JAX decode, port forward, port decode), each (STEPS,
    V) float32, for the weights of PRNGKey(param) and the tokens of
    PRNGKey(2)."""
    jcfg = JREG.get_smoke_config(ARCH).replace(dtype="bfloat16")
    tcfg = TREG.get_smoke_config(ARCH).replace(dtype="bfloat16")
    params = JMD.init_params(jcfg, jax.random.PRNGKey(request.param))
    toks = jax.random.randint(jax.random.PRNGKey(2), (1, STEPS), 0,
                              jcfg.vocab_size)
    jf = np.asarray(JMD.logits_fn(jcfg, params, toks)[0], np.float32)
    step = jax.jit(lambda p, st, t, pos: JMD.decode_step(jcfg, p, st, t,
                                                         pos))
    state = JMD.init_decode_state(jcfg, 1, STEPS)
    jd = []
    for t in range(STEPS):
        lg, state = step(params, state, toks[:, t], jnp.int32(t))
        jd.append(np.asarray(lg[0], np.float32))
    tparams = interop.model_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")
    ttoks = torch.tensor(np.asarray(toks), dtype=torch.long)
    with torch.no_grad():
        tf = TMD.logits_fn(tcfg, tparams, ttoks)[0].float().numpy()
        state = TMD.init_decode_state(tcfg, 1, STEPS, "cpu")
        td = []
        for t in range(STEPS):
            lg, state = TMD.decode_step(tcfg, tparams, state, ttoks[:, t], t)
            td.append(lg[0].float().numpy())
    return jf, np.stack(jd), tf, np.stack(td)


def test_decode_reading_within_jax_s(logits):
    jf, jd, tf, td = logits
    assert reading(td, tf) <= RATIO * reading(jd, jf)
    assert reading(jd, jf) < LOGITS_REL_TOL


def test_decode_and_forward_match_jax_in_bf16(logits):
    jf, jd, tf, td = logits
    assert reading(tf, jf) < LOGITS_REL_TOL
    assert reading(td, jd) < LOGITS_REL_TOL
