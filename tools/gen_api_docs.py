"""Generate the markdown API reference from package docstrings.

The reference ships Sphinx autosummary docs; this is
the dependency-free analog: one markdown page per module under docs/api/,
rendered from the live signatures and docstrings, so the reference cannot
drift from the source. tests/test_docs.py asserts the committed tree matches
a fresh render.

Usage: python tools/gen_api_docs.py [output_dir]   (default: docs/api)
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Pin CPU before importing the package: any module constant whose repr
# touches a device would otherwise compile on (and hold) the accelerator
# inside the docs build.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

PACKAGE = "pyspeedy_tpu"

# Modules whose import requires optional runtime context (none currently).
SKIP = set()


def _public_names(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None:
            continue
        # Only objects defined in (or re-exported by) this package.
        owner = getattr(obj, "__module__", None)
        if inspect.ismodule(obj):
            continue
        if owner is not None and not owner.startswith(PACKAGE):
            continue
        out.append((n, obj))
    return out


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj):
    d = inspect.getdoc(obj)
    return d.strip() if d else "*(no docstring)*"


def _render_function(name, fn, level="###"):
    return (f"{level} `{name}{_signature(fn)}`\n\n{_doc(fn)}\n")


def _render_class(name, cls):
    parts = [f"### `{name}{_signature(cls)}`\n\n{_doc(cls)}\n"]
    members = []
    for mname, m in inspect.getmembers(cls):
        if mname.startswith("_"):
            continue
        if inspect.isfunction(m) or inspect.ismethod(m):
            if m.__qualname__.split(".")[0] != cls.__name__:
                continue  # inherited
            members.append((mname, m, "method"))
        elif isinstance(inspect.getattr_static(cls, mname, None), property):
            members.append((mname, m, "property"))
    for mname, m, kind in members:
        if kind == "method":
            parts.append(f"#### `{name}.{mname}{_signature(m)}`\n\n{_doc(m)}\n")
        else:
            doc = inspect.getdoc(inspect.getattr_static(cls, mname).fget)
            if doc:
                parts.append(f"#### `{name}.{mname}` *(property)*\n\n"
                             f"{doc.strip()}\n")
    return "\n".join(parts)


def render_module(modname):
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`\n"]
    if mod.__doc__:
        lines.append(inspect.getdoc(mod).strip() + "\n")
    names = _public_names(mod)
    classes = [(n, o) for n, o in names if inspect.isclass(o)]
    funcs = [(n, o) for n, o in names if inspect.isfunction(o)]
    consts = [(n, o) for n, o in names
              if not inspect.isclass(o) and not inspect.isfunction(o)
              and not inspect.ismodule(o)]
    if classes:
        lines.append("## Classes\n")
        for n, o in classes:
            lines.append(_render_class(n, o))
    if funcs:
        lines.append("## Functions\n")
        for n, o in funcs:
            lines.append(_render_function(n, o))
    if consts:
        lines.append("## Data\n")
        for n, o in consts:
            if isinstance(o, (set, frozenset)):
                # set iteration order is hash-randomized: render sorted so
                # regeneration is deterministic (tests/test_docs.py).
                rep = (type(o).__name__ + "({"
                       + ", ".join(repr(x) for x in sorted(o, key=repr))
                       + "})")
            else:
                rep = repr(o)
            if len(rep) > 200:
                rep = rep[:200] + " ..."
            lines.append(f"### `{n}`\n\n```python\n{rep}\n```\n")
    return "\n".join(lines) + "\n"


def iter_modules():
    pkg = importlib.import_module(PACKAGE)
    yield PACKAGE
    for info in sorted(pkgutil.walk_packages(pkg.__path__, PACKAGE + "."),
                       key=lambda i: i.name):
        if info.name in SKIP or info.name.rsplit(".", 1)[-1].startswith("_"):
            continue
        yield info.name


def generate(outdir):
    os.makedirs(outdir, exist_ok=True)
    index = ["# API reference (generated)\n",
             "Rendered from the package docstrings by "
             "`tools/gen_api_docs.py`; do not edit by hand. "
             "`python tools/gen_api_docs.py` regenerates this tree "
             "(guarded by `tests/test_docs.py`).\n"]
    written = []
    for modname in iter_modules():
        try:
            text = render_module(modname)
        except Exception as e:  # noqa: BLE001 - skip unimportable modules
            print(f"skip {modname}: {e}", file=sys.stderr)
            continue
        fname = modname.replace(".", "_") + ".md"
        with open(os.path.join(outdir, fname), "w") as f:
            f.write(text)
        written.append(fname)
        mod = importlib.import_module(modname)
        first = (inspect.getdoc(mod) or "").strip().split("\n")[0]
        index.append(f"- [`{modname}`]({fname}) — {first}")
    with open(os.path.join(outdir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    return written


if __name__ == "__main__":
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "api")
    files = generate(outdir)
    print(f"wrote {len(files)} module pages + index.md to {outdir}")
