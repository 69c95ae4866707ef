"""The port's coverage of ceph_tpu's public surface, read from the source.

Every module of ``ceph_tpu/`` has a counterpart in ``ceph_tpu_torch/``
(the same path, or the one ``RENAMED_MODULES`` gives), and every public
name of the reference module is defined there too, under its own name or
the one ``RENAMED_NAMES`` gives, unless ``EXEMPT`` names it with its
reason. A public name is a top-level function or class, a public method
of a public class, a module constant, and each name a package's
``__init__.py`` imports. An exemption that the port defines after all,
or that the reference no longer defines, fails the test, so the table
cannot go stale.

The comparison reads both packages with ``ast`` and imports neither. The
import cases run the port alone in fresh interpreters: each package
resolves every name its reference counterpart re-exports and loads no
CUDA library, every module imports with no other module of the port
loaded before it, and neither ``jax`` nor ``ceph_tpu`` is imported.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "ceph_tpu"
PORT = REPO / "ceph_tpu_torch"

# reference module -> the port's module of another name
RENAMED_MODULES = {
    "crush/pallas_mapper.py": "crush/kernels.py",
    "gf/pallas_kernels.py": "gf/kernels.py",
    "ec/jax_plugin.py": "ec/torch_plugin.py",
}

# (reference module, name) -> the port's name for it; a renamed class
# renames its methods too
RENAMED_NAMES = {
    ("ec/jax_plugin.py", "ErasureCodeJax"): "ErasureCodeTorch",
    ("ec/__init__.py", "ErasureCodeJax"): "ErasureCodeTorch",
    ("gf/pallas_kernels.py", "gf_encode_batch_pallas"): "gf_encode",
    ("gf/pallas_kernels.py", "gf_matmul_bitplanes_pallas"): "gf_encode",
}

# (reference module, name or None for the whole module) -> why the port
# has no counterpart
EXEMPT = {
    ("utils/platform.py", None):
        "JAX shims (enable_x64, shard_map, the platform env); no JAX here",
    ("crush/pallas_mapper.py", "LANES"):
        "the Pallas cell width; the CUDA block width is kernels.THREADS",
    ("crush/pallas_mapper.py", "MIN_LANES"):
        "one TPU lane tile, the least Pallas cell width",
    ("crush/pallas_mapper.py", "VMEM_BUDGET"):
        "the scoped-VMEM model behind the Pallas geometry search",
    ("crush/pallas_mapper.py", "KERNEL_VARIANT"):
        "names the Pallas body's build variant",
    ("crush/pallas_mapper.py", "ABLATE_STAGES"):
        "stage ablations of the Pallas body",
    ("crush/pallas_mapper.py", "CRUSH_HASH_SEED"):
        "the Pallas body's copy of the seed: crush/hash.py and csrc kSeed",
    ("crush/pallas_mapper.py", "MAX_REWEIGHT"):
        "the reweights the Pallas body carries; the CUDA kernel reads all",
    ("crush/pallas_mapper.py", "MAX_CLASSES"):
        "the f32 weight-class draw; the CUDA draw is mapper.c's, exact",
    ("crush/pallas_mapper.py", "MAX_CONT_SLOTS"):
        "the f32 continuous draw's row width; the CUDA draw is exact",
    ("crush/pallas_mapper.py", "MAX_CONT_WEIGHT"):
        "the f32 continuous draw's weight split; the CUDA draw is exact",
    ("crush/pallas_mapper.py", "MARGIN_ABS"):
        "the f32 draw's flag margin; the CUDA draw is exact",
    ("crush/pallas_mapper.py", "MARGIN_REL"):
        "the f32 draw's flag margin; the CUDA draw is exact",
    ("crush/pallas_mapper.py", "ERR_Z"):
        "the f32 draw's error envelope; the CUDA draw is exact",
    ("crush/pallas_mapper.py", "REL_SLOP"):
        "the f32 draw's error envelope; the CUDA draw is exact",
    ("crush/pallas_mapper.py", "HAVE_PALLAS"):
        "whether jax.experimental.pallas imports",
    ("gf/pallas_kernels.py", "HAVE_PALLAS"):
        "whether jax.experimental.pallas imports",
    ("gf/pallas_kernels.py", "TILE_L"):
        "a Pallas column tile; csrc/gf_encode.cu sizes its own blocks",
    ("gf/pallas_kernels.py", "TILE_MAX"):
        "a Pallas column tile; csrc/gf_encode.cu sizes its own blocks",
    ("gf/pallas_kernels.py", "pallas_ok"):
        "whether Pallas runs on this backend",
    ("crush/mapper.py", "S64_MAX"):
        "the XLA VM's argmin sentinel; the port's VM takes mapper.c's "
        "argmax with S64_MIN",
    ("crush/mapper.py", "SPEC_TRIES"):
        "the XLA VM's speculative tries per slot; the port's VM loops",
    ("bench/ec_benchmark.py", "log"):
        "a logger the reference module binds and never uses",
}

EXPORTING_PACKAGES = ("crush", "ec", "gf", "osd", "utils")


def _bound(body, imports: bool) -> set:
    """Public names bound by module-level statements (through ``if`` and
    ``try`` blocks), with ``Class.method`` for public classes; imported
    names only when ``imports``."""
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out |= {f"{node.name}.{b.name}" for b in node.body
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not b.name.startswith("_")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out |= {n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and imports:
            if isinstance(node, ast.ImportFrom) and \
                    node.module == "__future__":
                continue
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.If):
            out |= _bound(node.body + node.orelse, imports)
        elif isinstance(node, ast.Try):
            out |= _bound(node.body + node.orelse + node.finalbody
                          + [s for h in node.handlers for s in h.body],
                          imports)
    return {n for n in out if not n.split(".")[0].startswith("_")}


def public_names(path: Path, imports: bool) -> set:
    return _bound(ast.parse(path.read_text()).body, imports)


def ref_modules() -> list:
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def port_module(rel: str) -> Path:
    return PORT / RENAMED_MODULES.get(rel, rel)


def port_name(rel: str, name: str) -> str:
    cls, dot, rest = name.partition(".")
    return RENAMED_NAMES.get((rel, cls), cls) + dot + rest


@pytest.mark.parametrize("rel", ref_modules())
def test_every_public_name_has_a_counterpart(rel):
    if (rel, None) in EXEMPT:
        return                       # test_exemptions_are_live holds it
    port = port_module(rel)
    assert port.is_file(), f"ceph_tpu/{rel} has no counterpart in the port"
    want = public_names(REF / rel, imports=rel.endswith("__init__.py"))
    have = public_names(port, imports=True)
    missing = sorted(n for n in want
                     if (rel, n.split(".")[0]) not in EXEMPT
                     and port_name(rel, n) not in have)
    assert not missing, \
        f"ceph_tpu/{rel}: no counterpart in {port.relative_to(REPO)}"


@pytest.mark.parametrize("rel,name", sorted(EXEMPT, key=str))
def test_exemptions_are_live(rel, name):
    """An exemption names what the reference defines and the port does
    not: one the port catches up on must leave the table."""
    assert EXEMPT[(rel, name)]
    assert (REF / rel).is_file()
    port = port_module(rel)
    if name is None:
        assert not port.exists(), f"the port now has {rel}"
        return
    assert name in public_names(REF / rel, imports=False)
    assert not port.is_file() or \
        name not in public_names(port, imports=True), \
        f"the port defines {name} in {port.relative_to(REPO)}: " \
        f"drop its exemption"


@pytest.mark.parametrize("key", sorted(RENAMED_MODULES.items()) +
                         sorted(RENAMED_NAMES.items()), ids=str)
def test_renames_are_live(key):
    """Each rename's reference side exists, and its port side exists,
    and the reference's name is not defined in the port besides."""
    ref, port = key
    if isinstance(ref, str):
        assert (REF / ref).is_file() and (PORT / port).is_file()
        assert not (PORT / ref).exists()
        return
    rel, name = ref
    assert name in public_names(REF / rel, imports=True)
    have = public_names(port_module(rel), imports=True)
    assert port in have and name not in have


IMPORT_CHECK = """
import importlib, json, sys
pkg, names = sys.argv[1], json.loads(sys.argv[2])
mod = importlib.import_module("ceph_tpu_torch." + pkg)
unresolved = [n for n in names if not hasattr(mod, n)]
foreign = sorted(m for m in sys.modules if m in ("jax", "ceph_tpu")
                 or m.startswith(("jax.", "jaxlib", "ceph_tpu.")))
build = sys.modules.get("ceph_tpu_torch.utils.cuda_build")
loaded = build.load.cache_info().currsize if build else 0
print(json.dumps([unresolved, foreign, loaded]))
"""


@pytest.mark.parametrize("pkg", EXPORTING_PACKAGES)
def test_package_exports_resolve_alone(pkg):
    rel = f"{pkg}/__init__.py"
    names = sorted(port_name(rel, n)
                   for n in public_names(REF / rel, imports=True))
    assert names
    out = subprocess.run([sys.executable, "-c", IMPORT_CHECK, pkg,
                          json.dumps(names)], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    unresolved, foreign, loaded = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert unresolved == [], f"ceph_tpu_torch.{pkg} lacks {unresolved}"
    assert foreign == []
    assert loaded == 0              # kernels load at their first launch


MODULES_ALONE = """
import importlib, json, pkgutil, sys
import ceph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ceph_tpu_torch.__path__,
                                               "ceph_tpu_torch.")]
failed = []
for name in names:
    for loaded in [m for m in sys.modules
                   if m.startswith("ceph_tpu_torch.")]:
        del sys.modules[loaded]
    try:
        importlib.import_module(name)
    except Exception as e:
        failed.append(f"{name}: {type(e).__name__}: {e}")
print(json.dumps([len(names), failed]))
"""


def test_every_module_imports_alone():
    """Each module imports first, with none of the port loaded before it
    (torch stays loaded), so no import order hides a cycle."""
    out = subprocess.run([sys.executable, "-c", MODULES_ALONE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, failed = json.loads(out.stdout.strip().splitlines()[-1])
    assert count >= len(ref_modules())
    assert failed == []
