"""The port stands alone: it imports with JAX and the JAX package blocked,
and no file of it (nor chip_smoke.py) imports either of them, nor a
package the card's machine lacks (ml_dtypes, safetensors, aiohttp,
prometheus_client); transformers only inside a function, when a model's
own tokenizer is loaded; its kernel sources and build stay out of module
import."""

import ast
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401 — test files import both frameworks, as the suite does
import pytest
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "llm_d_fast_model_actuation_tpu_torch"
FORBIDDEN = ("jax", "llm_d_fast_model_actuation_tpu", "ml_dtypes", "safetensors", "aiohttp", "prometheus_client")
#: importable by the port only lazily, inside a function
LAZY = ("transformers",)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    # exact name or a submodule: "llm_d_fast_model_actuation_tpu_torch" is
    # NOT the JAX package, though its name starts with it
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['llm_d_fast_model_actuation_tpu'] = None\n"
        f"for m in {list(FORBIDDEN[2:] + LAZY)!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) + ["chip_smoke.py", "capture_overlap.py",
                                                                  "profile_windows.py"],
)
def test_no_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py", "parity_spread.py", "capture_overlap.py", "profile_windows.py"],
)
def test_transformers_is_imported_only_inside_functions(path):
    tree = ast.parse((ROOT / path).read_text())
    lazy = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lazy.update(id(n) for n in ast.walk(fn))
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
        for n in names:
            if any(n == f or n.startswith(f + ".") for f in LAZY):
                assert id(node) in lazy, f"{path}:{node.lineno} imports {n} at module level"


def test_the_walk_covers_the_parallel_package():
    mods = set(_modules())
    for m in ("parallel", "parallel.mesh", "models.llama", "ops.cuda.ragged", "engine.server", "engine.arena",
              "engine.graphs", "engine.tokenizer", "models.hf", "models.safetensors", "launcher", "launcher.main",
              "launcher.rest", "launcher.notifier", "launcher.http11", "native.nvml", "utils.events", "api.constants",
              *CONTROL_PLANE):
        assert f"llm_d_fast_model_actuation_tpu_torch.{m}" in mods


#: the dual-pods control plane: none of it needs torch
CONTROL_PLANE = ("api", "api.spi", "api.types", "utils.hashing", "utils.syncbarrier", "parallel.topology",
                 "requester", "requester.spi", "requester.probes", "requester.allocation", "requester.main",
                 "controller", "controller.store", "controller.kubestore", "controller.metrics",
                 "controller.clients", "controller.directpath", "controller.populator", "controller.dualpods",
                 "controller.__main__", "controller.chipmap_tool", "admission", "testing")


def test_the_control_plane_imports_without_torch():
    code = (
        "import sys\n"
        f"for m in {list(FORBIDDEN + LAZY) + ['torch']!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {['llm_d_fast_model_actuation_tpu_torch.' + m for m in CONTROL_PLANE]!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_forbidden_match_is_exact_or_dotted():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("llm_d_fast_model_actuation_tpu.engine")
    assert not _forbidden("llm_d_fast_model_actuation_tpu_torch.engine")
    assert not _forbidden("jaxlib_like_name")
    assert _forbidden("safetensors.torch") and not _forbidden("llm_d_fast_model_actuation_tpu_torch.models.safetensors")


def test_kernel_build_finds_the_sources_and_names_libraries_by_content():
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build

    for src in build.SOURCES.values():
        assert (build.CSRC / src).is_file()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # the build directory is ignored by git, inside the checkout
    assert build.BUILD_DIR.is_relative_to(ROOT)
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    name = build._target("decode").name
    assert name.startswith("libdecode-") and name.endswith(".so")
