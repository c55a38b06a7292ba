"""The port's dry run (``launch/dryrun.py``) on the small fake meshes of
the tests, for every arch of the registry and the two variants whose
heads (and whisper's vocab) the 2-way 'model' axis does not divide
(``dryrun.SMALL_VARIANTS``, padded to it): its smoke config (remat on)
at B 4 x S 32 through the train, prefill and decode steps on a 2 x 2
(data, model) mesh and through the FL round (2 local steps) on a
2 x 2 x 2 (pod, data, model) mesh (``dryrun.SMALL_CASES``).  Each arch
runs in a process of its own (``python -m repro_torch.launch.dryrun
--small-meshes``), side by side, so the fake process group never meets
another test.

Every record must be ``ok``, with the port's own parameter count and
argument bytes: each input's local shard by the port's sanitized specs
(``sharding.rules``).  The file imports nothing of JAX, so it also runs
on a host without it, under that host's torch:

  python -m pytest -q -p no:cacheprovider tests/test_torch_small_mesh.py

With a CUDA device the records are taken on cuda fake tensors, as
chip_smoke.py's dry runs are; else on the CPU's."""
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.models import model as MD
from repro_torch.sharding import rules as R

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
AXES = {"data": 2, "model": 2}


@pytest.fixture(scope="module")
def records():
    """{(arch, case): record}, each arch's sweep in a process of its own,
    all started together."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    with tempfile.TemporaryDirectory() as out:
        procs = {arch: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--small-meshes", "--arch", arch, "--device", DEVICE,
             "--results-dir", out, "--quiet"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
            for arch in DR.SMALL_ARCHS}
        logs = {arch: p.communicate(timeout=600)[0]
                for arch, p in procs.items()}
        recs = {}
        for arch in DR.SMALL_ARCHS:
            for case in DR.SMALL_CASES:
                path = Path(DR.result_path(arch, f"small_{case}", False, "",
                                           out))
                assert path.exists(), logs[arch][-3000:]
                recs[arch, case] = json.loads(path.read_text())
    return recs


def _local_bytes(metas, specs, axes):
    """Bytes of each meta tensor's local shard under its sanitized spec."""
    specs = R.sanitize_specs(specs, metas, axes)
    return sum(v.numel() // math.prod(R._n_shards(e, axes) for e in specs[k])
               * v.element_size() for k, v in metas.items())


def _argument_bytes(cfg, case):
    """The step's inputs' local bytes on the case's mesh by the port's
    specs: parameters (stacked over the cohorts for the FL round), and
    the batch, or the decode state and tokens."""
    pflat = MD.flatten_params(SP.params_shape(cfg))
    pspecs = R.param_specs(cfg, pflat)
    kind = "train" if case == "fl_round" else case
    shape = ShapeConfig("small", DR.SMALL_S, DR.SMALL_B, kind)
    inputs = SP.train_input_specs(cfg, shape)
    if case == "fl_round":
        axes = dict(AXES, pod=2)
        steps = DR.SMALL_FL_STEPS
        cmeta = {k: SP.sds((2,) + v.shape, v.dtype) for k, v in pflat.items()}
        cspecs = {k: ("pod", *s) for k, s in
                  R.sanitize_specs(pspecs, pflat, axes).items()}
        bmeta = {k: SP.sds((2, steps, v.shape[0] // 2) + v.shape[1:],
                           v.dtype) for k, v in inputs.items()}
        bspecs = {k: ("pod", None, *s) for k, s in
                  R.train_batch_specs(cfg, multi_pod=False).items()}
        return (_local_bytes(cmeta, cspecs, axes)
                + _local_bytes(bmeta, bspecs, axes))
    params = _local_bytes(pflat, pspecs, AXES)
    if kind in ("train", "prefill"):
        return params + _local_bytes(inputs, R.train_batch_specs(cfg), AXES)
    state = MD.flatten_params(MD.init_decode_state(
        cfg, DR.SMALL_B, DR.SMALL_S, device=SP.META))
    tokens = {"tokens": SP.sds((DR.SMALL_B,), torch.int32)}
    return (params
            + _local_bytes(state, R.decode_state_specs(
                cfg, state, DR.SMALL_B, AXES), AXES)
            + _local_bytes(tokens, R.decode_batch_specs(cfg, DR.SMALL_B),
                           AXES))


@pytest.mark.parametrize("case", DR.SMALL_CASES)
@pytest.mark.parametrize("arch", DR.SMALL_ARCHS)
def test_small_mesh_record_ok(records, arch, case):
    """The case runs ``ok`` on its mesh, with the smoke config's
    parameter count and the argument bytes of the port's specs; no
    cross-pod bytes on one pod, and on the FL round the
    FedAvg's float32 all-reduce of the parameter shard across pods,
    exactly."""
    rec = records[arch, case]
    assert rec["status"] == "ok", (rec.get("site"), rec.get("error"),
                                   rec.get("traceback"))
    cfg = DR.small_config(arch)
    flat = MD.flatten_params(SP.params_shape(cfg))
    assert rec["n_params"] == sum(v.numel() for v in flat.values())
    assert rec["n_devices"] == (8 if case == "fl_round" else 4)
    assert rec["memory"]["argument_size_in_bytes"] == \
        _argument_bytes(cfg, case)
    coll = rec["collectives"]
    if case == "fl_round":
        specs = R.sanitize_specs(R.param_specs(cfg, flat), flat, AXES)
        shard = sum(v.numel() // math.prod(R._n_shards(e, AXES)
                                           for e in specs[k])
                    for k, v in flat.items())
        assert coll["cross_pod"] == 4 * shard
    else:
        assert coll["cross_pod"] == 0
