"""``python -m repro_torch.launch.train --mode transformer`` against the
JAX CLI on the CPU, and the archs and runtimes it refuses.

The CLI run (``--clients 50 --rounds 2``: 10 FL clients at qwen2-0.5b's
smoke config) must select the JAX CLI's clients in every round, with
its stage-1 labels, and its per-round test loss, accuracy and energy
std within 1e-5."""
import sys

import numpy as np
import pytest
import torch

import repro.launch.train as JTRAIN
from repro_torch.launch import train as TRAIN

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

ARGS = ["--mode", "transformer", "--clients", "50", "--rounds", "2",
        "--quiet"]


def _recording(module, monkeypatch):
    """Keep every FederatedServer ``module``'s CLI builds."""
    servers = []

    class Recording(module.FederatedServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    monkeypatch.setattr(module, "FederatedServer", Recording)
    return servers


def test_cli_matches_jax_cli(monkeypatch, capsys):
    j_servers = _recording(JTRAIN, monkeypatch)
    monkeypatch.setattr(sys, "argv", ["train", *ARGS])
    JTRAIN.main()
    j_out = capsys.readouterr().out
    t_servers = _recording(TRAIN, monkeypatch)
    got = TRAIN.main(["--device", "cpu", *ARGS])
    t_out = capsys.readouterr().out
    js, ts = j_servers[-1], t_servers[-1]
    assert ts.cfg.num_clients == js.cfg.num_clients == 10
    np.testing.assert_array_equal(ts.state.clusters.numpy(),
                                  np.asarray(js.state.clusters))
    assert got["selected"] == [l.selected.tolist() for l in js.logs]
    for f in ("test_loss", "test_acc", "energy_std"):
        np.testing.assert_allclose(got[f], [getattr(l, f) for l in js.logs],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert got["mode"] == "transformer" and got["arch"] == "qwen2-0.5b"
    # the closing line, wall time aside
    final = [l.rsplit(" wall=", 1)[0] for out in (j_out, t_out)
             for l in out.splitlines() if l.startswith("final acc=")]
    assert len(final) == 2 and final[0] == final[1]


@pytest.mark.parametrize("flag", [
    ["--arch", "granite-moe-3b-a800m"],           # MoE blocks
    ["--arch", "jamba-v0.1-52b"],                 # Mamba and MoE blocks
    ["--arch", "xlstm-1.3b"],                     # sLSTM/mLSTM blocks
    ["--arch", "whisper-tiny"],                   # encoder-decoder
    ["--runtime", "sharded"],
])
def test_unported_transformer_flags_raise(flag):
    with pytest.raises(NotImplementedError):
        TRAIN.main(["--device", "cpu", *ARGS, *flag])
