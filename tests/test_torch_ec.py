"""The port's erasure-code plugin held against ceph_tpu's, byte for byte.

``ErasureCodeTorch(device="cpu")`` and ``ErasureCodeJax`` (on JAX's CPU
backend) get the same profiles and the same numpy inputs, made from a
seed, across all seven techniques at small sizes. Also: the registry's
aliases, the port's benchmark CLI on the CPU, the port's imports, and
the rule that nothing runs on the CPU unless asked.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.ec.jax_plugin import ErasureCodeJax
from ceph_tpu_torch.bench import ec_benchmark
from ceph_tpu_torch.ec import registry as registry_mod
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch
from ceph_tpu_torch.interop.native import ErasureCodeRef
from ceph_tpu_torch.utils import device as devsel
from ceph_tpu_torch.utils import roofline, timing

REPO = Path(__file__).resolve().parents[1]
TECHNIQUES = ["reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good",
              "liberation", "blaum_roth", "liber8tion"]


def _profile(technique: str, k: int = 4) -> str:
    m = 3 if technique in ("reed_sol_van", "cauchy_orig",
                           "cauchy_good") else 2
    return f"k={k} m={m} technique={technique}"


def _pair(technique: str, backend: str = "auto"):
    prof = _profile(technique)
    mine = ErasureCodeTorch(f"{prof} backend={backend}", device="cpu")
    theirs = ErasureCodeJax(prof)
    assert (mine.k, mine.m, mine.w) == (theirs.k, theirs.m, theirs.w)
    return mine, theirs


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_encode_chunks_equal(rng, technique):
    mine, theirs = _pair(technique)
    data = rng.integers(0, 256, size=(mine.k, mine.get_alignment()),
                        dtype=np.uint8)
    got = mine.encode_chunks(data)
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, theirs.encode_chunks(data))


@pytest.mark.parametrize("backend", ["kernel", "bitmatmul", "lut"])
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_encode_batch_equal(rng, technique, backend):
    mine, theirs = _pair(technique, backend)
    data = rng.integers(0, 256, size=(3, mine.k, 2 * mine.get_alignment()),
                        dtype=np.uint8)
    got = _np(mine.encode_batch(data))
    assert np.array_equal(got, _np(theirs.encode_batch(data)))
    assert np.array_equal(got, mine.encode_batch_reference(data))


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_decode_batch_equal(rng, technique):
    mine, theirs = _pair(technique)
    data = rng.integers(0, 256, size=(2, mine.k, mine.get_alignment()),
                        dtype=np.uint8)
    full = np.concatenate([data, mine.encode_batch_reference(data)], axis=1)
    want, avail = [0, mine.k], [i for i in range(1, mine.k + mine.m)
                                if i != mine.k]
    chunks = np.ascontiguousarray(full[:, avail])
    got = _np(mine.decode_batch(want, avail, chunks))
    assert np.array_equal(got, full[:, want])
    assert np.array_equal(got, _np(theirs.decode_batch(want, avail, chunks)))
    assert np.array_equal(got, mine.decode_batch_reference(want, avail,
                                                           chunks))


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_decode_chunks_equal(rng, technique):
    mine, theirs = _pair(technique)
    data = rng.integers(0, 256, size=(mine.k, mine.get_alignment()),
                        dtype=np.uint8)
    parity = mine.encode_chunks(data)
    have = {i: data[i] for i in range(2, mine.k)}
    have.update({mine.k + j: parity[j] for j in range(mine.m)})
    got = mine.decode_chunks([0, 1], have)
    ref = theirs.decode_chunks([0, 1], have)
    for c in (0, 1):
        assert np.array_equal(got[c], data[c])
        assert np.array_equal(got[c], np.asarray(ref[c]))


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_bytes_roundtrip_equal(rng, technique):
    mine, theirs = _pair(technique)
    payload = rng.integers(0, 256, size=3000, dtype=np.uint8).tobytes()
    n = mine.get_chunk_count()
    enc = mine.encode(range(n), payload)
    assert enc == theirs.encode(range(n), payload)
    del enc[0], enc[n - 1]
    out = mine.decode_concat(enc)
    assert out[:len(payload)] == payload
    assert out == theirs.decode_concat(enc)


def test_backend_names():
    assert ErasureCodeTorch("k=2 m=2", device="cpu").backend == "kernel"
    assert ErasureCodeTorch("k=2 m=2 backend=pallas",
                            device="cpu").backend == "kernel"
    with pytest.raises(ValueError):
        ErasureCodeTorch("k=2 m=2 backend=nope", device="cpu")
    with pytest.raises(ValueError):
        ErasureCodeTorch("k=0 m=2", device="cpu")


@pytest.mark.parametrize("name", ["jax", "jerasure", "isa"])
def test_registry_aliases(rng, name):
    """jax and jerasure are the torch plugin; isa with an RS/Cauchy
    technique is the independent native backend where the toolchain
    builds it (as in ceph_tpu), the torch plugin otherwise. All give
    ceph_tpu's parity."""
    reg = ErasureCodePluginRegistry.instance()
    ec = reg.factory(name, "k=3 m=2 technique=cauchy_good device=cpu")
    if name == "isa" and registry_mod._native_available():
        assert isinstance(ec, ErasureCodeRef) and ec.independent is True
    else:
        assert isinstance(ec, ErasureCodeTorch)
        assert ec.device.type == "cpu"
        assert getattr(ec, "independent", None) is (False if name == "isa"
                                                    else None)
    data = rng.integers(0, 256, size=(3, 128), dtype=np.uint8)
    ref = ErasureCodeJax("k=3 m=2 technique=cauchy_good")
    assert np.array_equal(ec.encode_chunks(data), ref.encode_chunks(data))


@pytest.mark.parametrize("name", ["lrc", "shec", "clay", "ref"])
def test_registry_layered_and_native_plugins_found(name):
    """The layered plugins and ``ref`` (the native C++ backend) are
    registered; an unknown name is not found."""
    reg = ErasureCodePluginRegistry.instance()
    if name == "ref":
        with pytest.raises(KeyError, match="not found"):
            reg.factory("nosuch", "k=2 m=2")
        assert reg.load("ref") is ErasureCodeRef
        if registry_mod._native_available():
            ec = reg.factory(name, "k=4 m=2")
            assert isinstance(ec, ErasureCodeRef)
            assert ec.get_data_chunk_count() == 4
        return
    ec = reg.factory(name, "k=4 m=2 device=cpu")
    assert type(ec).__module__ == f"ceph_tpu_torch.ec.{name}"
    assert ec.get_data_chunk_count() == 4


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        devsel.resolve(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErasureCodeTorch("k=2 m=2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErasureCodePluginRegistry.instance().factory("jax", "k=2 m=2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ec_benchmark.main(["--size", "256", "--parameter", "k=2",
                           "--parameter", "m=2"])
    assert devsel.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("workload", ["encode", "decode"])
def test_ec_benchmark_cli_on_cpu(capsys, workload):
    res = ec_benchmark.main([
        "--plugin", "jax", "--workload", workload, "--size", "4096",
        "--iterations", "3", "--erasures", "2", "--parameter", "k=4",
        "--parameter", "m=2", "--parameter", "device=cpu",
        "--slope-steps", "1", "2", "--json"])
    lines = capsys.readouterr().out.strip().splitlines()
    seconds, mbps = lines[0].split("\t")
    assert float(seconds) > 0 and float(mbps) > 0
    rec = json.loads(lines[1])
    assert rec == json.loads(json.dumps(res))
    assert (rec["platform"], rec["device"]) == ("cpu", "cpu")
    assert rec["batch"] == 3 and rec["chunk_size"] == 1024
    assert rec["timing"]["method"].endswith("host_clock")
    if workload == "decode":
        assert rec["erased"] == [0, 1] and rec["chunks_read"] == 4


def test_roofline_bounds():
    spec = roofline.device_spec("NVIDIA H100 80GB HBM3")
    assert spec.hbm_bytes_per_s == 3.35e12
    assert roofline.device_spec("NVIDIA H100 PCIe").hbm_bytes_per_s == 2.0e12
    assert roofline.device_spec("cpu") is None
    nbytes, ops = roofline.gf_encode_work(64, 8, 3, 524288)
    assert nbytes == 352 * 2**20
    secs, by = roofline.bound_seconds(nbytes, ops, spec)
    assert by == "bytes" and secs == nbytes / 3.35e12
    assert roofline.encode_bound(8, 3, spec) == 3.35e12 / (1 + 3 / 8)
    with pytest.raises(roofline.RooflineViolation):
        roofline.check(1.1 * 3.35e12, 3.35e12)


def test_anchor_depends_on_every_byte():
    x = torch.zeros((3, 5, 7), dtype=torch.uint8)
    base = int(timing.anchor(x))
    for idx in [(0, 0, 0), (2, 4, 6), (1, 2, 3)]:
        y = x.clone()
        y[idx] = 1
        assert int(timing.anchor(y)) != base


def test_port_imports_no_jax_and_no_ceph_tpu():
    """Run in a subprocess: tests/conftest.py has imported jax here."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ceph_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ceph_tpu_torch.__path__, 'ceph_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'ceph_tpu' or m.startswith('ceph_tpu.'))\n"
        "print(len(names), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 15
    assert bad.strip() == "[]"


def test_chip_smoke_refuses_without_cuda():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy, torch\n"
         "torch.cuda.is_available = lambda: False\n"
         "runpy.run_path('chip_smoke.py', run_name='__main__')\n"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert '"ok"' not in out.stdout
