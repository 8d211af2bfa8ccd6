"""The port does all that the JAX package does, as a check: both packages
are parsed with ``ast`` (nothing is imported, so no jax either), and every
JAX module file must have a port counterpart at the same path, holding
every public top-level function, class and class method of the JAX file,
and every parameter of each such function and method.

Substitutions and exceptions:
- a ``key`` or ``seed`` parameter (a JAX PRNG key) becomes a
  ``torch.Generator`` parameter, ``generator``;
- ``laser_slam_tpu/__init__.enable_compilation_cache``: the persistent XLA
  compile cache, not carried into the port;
- ``ops/pallas/*``: the Pallas TPU kernel, whose counterpart is the CUDA
  kernel's wrapper ``ops/cuda/psm_kernel.py`` (checked for its entry).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "laser_slam_tpu"
PORT = ROOT / "laser_slam_tpu_torch"

NOT_CARRIED = {("__init__.py", "enable_compilation_cache")}
KERNEL_DIR = "ops/pallas"
RANDOM_PARAMS = {"key", "seed"}


def _jax_files():
    return sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _public(tree: ast.Module) -> dict:
    """``{name: params}`` for top-level public functions, and
    ``{Class.method: params}`` (``Class: None``) for public classes."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not item.name.startswith("_") or item.name == "__init__"):
                    out[f"{node.name}.{item.name}"] = _params(item)
    return out


def _params(fn) -> list[str]:
    a = fn.args
    return [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)] + (
        [a.vararg.arg] if a.vararg else []) + ([a.kwarg.arg] if a.kwarg else [])


def _parse(path: Path) -> dict:
    return _public(ast.parse(path.read_text()))


def test_every_jax_module_has_a_port_counterpart():
    missing = [f for f in _jax_files()
               if not f.startswith(KERNEL_DIR) and not (PORT / f).exists()]
    assert not missing, missing
    # The Pallas kernel's counterpart: the CUDA kernel's wrapper.
    wrapper = _parse(PORT / "ops/cuda/psm_kernel.py")
    assert {"match_psm_fused", "build"} <= set(wrapper)


@pytest.mark.parametrize("rel", [f for f in _jax_files() if not f.startswith(KERNEL_DIR)])
def test_every_public_name_and_parameter_is_ported(rel):
    want = _parse(JAX / rel)
    got = _parse(PORT / rel)
    problems = []
    for name, params in want.items():
        if (rel, name) in NOT_CARRIED:
            continue
        if name not in got:
            problems.append(f"{name} missing")
            continue
        if params is None:
            continue
        have = set(got[name] or ())
        for p in params:
            if p in RANDOM_PARAMS:
                if "generator" not in have:
                    problems.append(f"{name}: {p} has no generator")
            elif p not in have:
                problems.append(f"{name}: parameter {p} missing")
    assert not problems, f"{rel}: {problems}"


def test_the_exceptions_are_still_needed():
    """Each exception names something the JAX package still has and the
    port does not."""
    for rel, name in NOT_CARRIED:
        assert name in _parse(JAX / rel) and name not in _parse(PORT / rel)
    assert any(f.startswith(KERNEL_DIR) for f in _jax_files())
