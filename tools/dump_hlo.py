"""Dump the optimized HLO of the batched ensemble step and attribute
DMA-heavy ops (slice/copy/dynamic-update-slice) to JAX source locations.

Usage: python tools/dump_hlo.py [n_members] [n_steps] [out.txt]
"""

import collections
import dataclasses
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pyspeedy_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from pyspeedy_tpu.models import model as M
from pyspeedy_tpu.params import T30L8
from pyspeedy_tpu.testing import make_demo_model
from pyspeedy_tpu.parallel.ensemble import broadcast_state, make_run_steps_batched


def main():
    n_members = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 36
    out_path = sys.argv[3] if len(sys.argv) > 3 else "step_hlo.txt"
    backend = jax.default_backend()
    precision = "f64" if backend == "cpu" else "f32"
    params = dataclasses.replace(T30L8, precision=precision,
                                 fft_mode="matmul")
    consts, state, cal = make_demo_model(params)
    bstate = broadcast_state(state, n_members)
    run = make_run_steps_batched(consts, donate=False, phase=2)
    ctx, cal = M.build_step_ctx(cal, 2, n_steps)
    txt = run.lower(bstate, ctx).compile().as_text()
    with open(out_path, "w") as f:
        f.write(txt)
    print(f"wrote {out_path} ({len(txt)} bytes)", file=sys.stderr)

    # Attribute slice/copy ops to source locations from metadata.
    pat = re.compile(
        r"%?(?P<op>slice|copy|dynamic-update-slice|dynamic-slice|transpose"
        r"|rev|pad|concatenate)[.\d]* = (?P<shape>\S+).*?"
        r"metadata={.*?source_file=\"(?P<file>[^\"]+)\""
        r".*?source_line=(?P<line>\d+)")
    counts = collections.Counter()
    for line in txt.splitlines():
        m = pat.search(line)
        if m:
            src = f"{os.path.basename(m.group('file'))}:{m.group('line')}"
            counts[(m.group("op"), src)] += 1
    for (op, src), c in counts.most_common(60):
        print(f"{c:5d}  {op:22s} {src}")


if __name__ == "__main__":
    main()
