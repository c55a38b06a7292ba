"""The port's examples (``examples/*_torch.py``): ``serve_decode_torch.py``
on the CPU prints the JAX package's ``examples/serve_decode.py`` ids,
whisper-tiny included, and every example runs on the card by default,
raising without one (nothing falls back to the CPU)."""
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
PORTED = ["quickstart", "scheme_comparison", "fl_pretrain_lm",
          "serve_decode"]


def _run(path, argv, monkeypatch):
    """Run an example's ``main`` in this process with ``argv``."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    return module.main()


def _first_sequence(text):
    lines = [l for l in text.splitlines() if l.startswith("first sequence:")]
    assert len(lines) == 1, text
    return lines[0]


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-0.5b"])
def test_serve_decode_prints_the_jax_example_ids(arch, monkeypatch, capsys):
    """Batch 2, 4 tokens from token 0; whisper first encodes frames drawn
    from PRNGKey(1), as the JAX example draws them."""
    args = ["--arch", arch, "--batch", "2", "--gen", "4"]
    _run(EXAMPLES / "serve_decode.py", args, monkeypatch)
    want = _first_sequence(capsys.readouterr().out)
    _run(EXAMPLES / "serve_decode_torch.py", [*args, "--device", "cpu"],
         monkeypatch)
    assert _first_sequence(capsys.readouterr().out) == want


@pytest.mark.parametrize("name", PORTED)
def test_examples_default_to_the_card(name, monkeypatch):
    """Without ``--device cpu`` an example asks for the GPU, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default would run there")
    with pytest.raises(RuntimeError, match="cuda|CUDA|GPU"):
        _run(EXAMPLES / f"{name}_torch.py", [], monkeypatch)
