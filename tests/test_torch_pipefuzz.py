"""The port's full-pipeline fuzzer (metagenomics_tpu_torch/measure/
pipefuzz.py) on the CPU.

* gen() writes tools/pipefuzz.gen's bytes in every mode (mix: both files);
* seed 9 in each mode through the port's CLI under the device engine gives
  the JAX CLI's 11 artifacts;
* every card engine equals native on a seed of each mode, as the tool
  reports it;
* the tool fails a seed, naming what differs, when an engine's artifact or
  rc differs from native's;
* asked for the card with none present, it raises.
"""

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

torch.set_num_threads(1)

from metagenomics_tpu_torch.measure import pipefuzz  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jfuzz = _load(os.path.join("tools", "pipefuzz.py"), "jax_pipefuzz")


def test_arts_are_the_jax_tools():
    assert pipefuzz.ARTS == jfuzz.ARTS


@pytest.mark.parametrize("seed", [7, 9, 20])
@pytest.mark.parametrize("mode", ["se", "pe", "mix"])
def test_gen_matches_tools_pipefuzz(tmp_path, monkeypatch, mode, seed):
    """tools/pipefuzz.run_one writes mix as a PE file (FUZZ_MODE=pe) and an
    SE file (FUZZ_MODE empty) from the same seed."""
    port = str(tmp_path / "port.fasta")
    args = pipefuzz.gen(seed, port, mode)
    want = {"se": [("", port)], "pe": [("pe", port)],
            "mix": [("pe", port), ("", pipefuzz.se_path(port))]}[mode]
    assert args[2::3] == [p for _, p in want]
    for env, path in want:
        monkeypatch.setenv("FUZZ_MODE", env)
        ref = str(tmp_path / "jax.fasta")
        jfuzz.gen(seed, ref)
        with open(ref, "rb") as f:
            data = f.read()
        assert len(data) > 100_000
        with open(path, "rb") as f:
            assert f.read() == data, (mode, env)


def _jax_cli(args, workdir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MGTPU_OVERLAP_ENGINE="device",
               OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    os.makedirs(workdir)
    proc = subprocess.run([sys.executable, "-m", "metagenomics_tpu.cli",
                           *args, "-f", "x_", "-l", "40"], cwd=workdir,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return os.path.join(workdir, "x_")


@pytest.mark.parametrize("mode", ["se", "pe", "mix"])
def test_seed_9_device_equals_the_jax_cli(tmp_path, mode):
    args = pipefuzz.gen(9, str(tmp_path / "f.fasta"), mode)
    prefix = str(tmp_path / "port_x_")
    rc, ran, launched = pipefuzz.run_cli(args, prefix, "device", CPU, 40)
    assert (rc, ran) == (0, "device")
    assert launched == {"window_hash": 0, "window_hash_at": 0}
    assert pipefuzz.diff_artifacts(
        prefix, _jax_cli(args, str(tmp_path / "jax"))) == []
    for art in pipefuzz.ARTS:
        assert os.path.getsize(prefix + art) > 0, art


@pytest.mark.parametrize("mode,seed", [("se", 20), ("pe", 7), ("mix", 9)])
def test_every_engine_equals_native(mode, seed):
    """The tool's summary: each card engine (sharded on a (2, 2) mesh of
    CPU shards) equal to native, and fit for the JSON line."""
    out = pipefuzz.fuzz([seed], mode, 40, pipefuzz.ENGINES, CPU,
                        with_binary=False)
    assert out["failures"] == []
    assert {e: r["equal_native"] for e, r in out["engines"].items()} == \
        {"device": 1, "hybrid": 1, "sharded": 1}
    assert out["native"] == {"binary_ran": False, "equal_binary": 0,
                             "differs_from_binary": {}}
    assert (out["mode"], out["seeds"], out["device"]) == (mode, [seed],
                                                          "cpu")
    json.dumps(out)


def _tampered(kind):
    """pipefuzz.run_cli, with the device engine's run spoiled by `kind`."""
    real = pipefuzz.run_cli

    def run(args, prefix, engine, device, l_opt, mesh=None):
        rc, ran, launched = real(args, prefix, engine, device, l_opt, mesh)
        if engine == "device":
            if kind == "content":
                with open(prefix + "graph2.gdl", "ab") as f:
                    f.write(b"\n")
            elif kind == "missing":
                os.remove(prefix + "contigs4.fasta")
            else:
                rc = 3
        return rc, ran, launched
    return run


@pytest.mark.parametrize("kind,named", [
    ("content", "graph2.gdl"), ("missing", "contigs4.fasta(exist)"),
    ("rc", "rc 3, native 0")])
def test_a_differing_engine_fails_the_seed(tmp_path, monkeypatch, capsys,
                                          kind, named):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(pipefuzz, "run_cli", _tampered(kind))
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FUZZ_ENGINE", "device,hybrid")
    monkeypatch.setattr(pipefuzz, "binary_runs", lambda: False)
    with pytest.raises(SystemExit, match="1 engine run"):
        pipefuzz.main(["7"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["engines"]["device"]["equal_native"] == 0
    assert out["engines"]["hybrid"]["equal_native"] == 1
    [fail] = out["failures"]
    assert (fail["seed"], fail["engine"]) == (7, "device")
    assert named in fail["differs"]
    assert os.path.dirname(fail["workdir"]) == str(tmp_path)


def test_asked_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.delenv("MGTPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipefuzz.main(["7"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipefuzz.fuzz([7], device="cuda")
