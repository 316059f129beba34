"""Nothing the harness or its reference imports, here or through the port's
modules it reaches, has the top-level name jax, jaxlib, flax or
text2nerf_tpu: a static scan, each name compared whole (the port's own
name begins with the JAX package's).  The reference imports nothing of
the port at all."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "text2nerf_tpu"}


def imports(path: Path):
    """Absolute names of the modules ``path`` imports."""
    rel = path.relative_to(ROOT).with_suffix("")
    package = list(rel.parts[:-1]) if rel.name != "__init__" else list(rel.parts[:-1])
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
                out.add(mod)
                out.update(f"{mod}.{a.name}" for a in node.names)
            else:
                out.add(node.module)
                out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def module_file(name: str):
    p = ROOT.joinpath(*name.split("."))
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.exists():
            return cand
    return None


def reachable(files):
    seen, todo, names = set(), list(files), set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in imports(f):
            names.add(name)
            if name.split(".")[0] in ("port_bench", "text2nerf_tpu_torch"):
                g = module_file(name)
                if g is not None:
                    todo.append(g)
    return seen, names


def test_the_harness_reaches_no_jax_and_no_jax_package():
    files = [p for p in (ROOT / "port_bench").rglob("*.py") if "tests" not in p.parts]
    seen, names = reachable(files)
    assert any(str(f).endswith("engine/train_step.py") for f in seen)
    top = {n.split(".")[0] for n in names}
    assert not top & FORBIDDEN, sorted(top & FORBIDDEN)
    assert "text2nerf_tpu_torch" in top


def test_the_reference_imports_nothing_of_the_port():
    files = list((ROOT / "port_bench" / "reference").rglob("*.py"))
    _, names = reachable(files)
    assert {n.split(".")[0] for n in names} <= {"port_bench", "torch", "numpy", "math",
                                                "__future__"}
