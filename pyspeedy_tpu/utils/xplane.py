"""Minimal XPlane (jax.profiler trace) reader.

jax.profiler.start_trace writes ``*.xplane.pb`` protobufs (the XSpace schema
from tsl/profiler). This module decodes the wire format directly, with no
protobuf or tensorboard dependency — just enough to aggregate per-op device
time, which is what kernel optimization needs.

Usage:
    from pyspeedy_tpu.utils.xplane import device_op_totals
    totals = device_op_totals("trace_dir")   # {op_name: seconds}
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict

__all__ = ["parse_xspace", "device_op_totals", "top_ops_report"]


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) from one message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # fixed64
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # fixed32
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, val


def _parse_event(buf: memoryview) -> tuple[int, int]:
    """XEvent -> (metadata_id, duration_ps * occurrences)."""
    mid = 0
    dur = 0
    occ = 1
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            mid = val
        elif fno == 3:
            dur = val
        elif fno == 5:
            occ = val
    return mid, dur * max(occ, 1)


def _parse_line(buf: memoryview) -> tuple[str, dict]:
    """XLine -> (name, {metadata_id: total_duration_ps})."""
    name = ""
    totals: dict = defaultdict(int)
    for fno, _wt, val in _fields(buf):
        if fno == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif fno == 4:
            mid, dps = _parse_event(val)
            totals[mid] += dps
    return name, totals


def _parse_event_metadata(buf: memoryview) -> tuple[int, str]:
    mid = 0
    name = ""
    display = ""
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            mid = val
        elif fno == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif fno == 3:
            display = bytes(val).decode("utf-8", "replace")
    return mid, display or name


def _parse_plane(buf: memoryview) -> dict:
    """XPlane -> {"name", "lines": [(line_name, {mid: ps})], "meta": {mid: name}}."""
    out = {"name": "", "lines": [], "meta": {}}
    for fno, _wt, val in _fields(buf):
        if fno == 2:
            out["name"] = bytes(val).decode("utf-8", "replace")
        elif fno == 3:
            out["lines"].append(_parse_line(val))
        elif fno == 4:  # map<int64, XEventMetadata> entry
            key = None
            md = None
            for efno, _ewt, eval_ in _fields(val):
                if efno == 1:
                    key = eval_
                elif efno == 2:
                    md = _parse_event_metadata(eval_)
            if md is not None:
                out["meta"][md[0] if key is None else key] = md[1]
    return out


def parse_xspace(path: str) -> list[dict]:
    """Parse one .xplane.pb file into a list of plane dicts."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    planes = []
    for fno, _wt, val in _fields(data):
        if fno == 1:
            planes.append(_parse_plane(val))
    return planes


def device_op_totals(trace_dir: str, plane_filter: str = "/device:",
                     line_filter: str = "Stream") -> dict:
    """Aggregate total seconds per op name over the kernel event lines of all
    device planes under a jax.profiler trace directory. On the GPU those are
    the per-stream lines ("Stream #13(Compute)", ...) of "/device:GPU:N",
    whose events are the kernels and copies; restricting to them avoids
    counting wrapper events of other lines."""
    paths = glob.glob(os.path.join(
        trace_dir, "**", "*.xplane.pb"), recursive=True)
    # Each start_trace/stop_trace session writes its own timestamped
    # subdirectory; aggregate only the NEWEST session, otherwise repeated
    # profiles of the same dir silently sum (and skew every percentage).
    sessions: dict = defaultdict(list)
    for p in paths:
        sessions[os.path.dirname(p)].append(p)
    if sessions:
        paths = sessions[max(sessions, key=os.path.getmtime)]
    totals: dict = defaultdict(float)
    for p in paths:
        for plane in parse_xspace(p):
            if plane_filter not in plane["name"]:
                continue
            meta = plane["meta"]
            for line_name, line_totals in plane["lines"]:
                if line_filter and line_filter not in (line_name or ""):
                    continue
                for mid, ps in line_totals.items():
                    totals[meta.get(mid, f"#{mid}")] += ps * 1e-12
    return dict(totals)


def _op_category(name: str) -> str:
    """HLO instruction name -> instruction kind ('%fusion.123 = ...' ->
    'fusion')."""
    head = name.lstrip("%").split(" ", 1)[0]
    return head.split(".", 1)[0].rstrip("0123456789")


def top_ops_report(trace_dir: str, n: int = 40,
                   plane_filter: str = "/device:") -> str:
    totals = device_op_totals(trace_dir, plane_filter)
    total = sum(totals.values()) or 1.0
    by_cat: dict = defaultdict(float)
    cat_n: dict = defaultdict(int)
    for name, secs in totals.items():
        by_cat[_op_category(name)] += secs
        cat_n[_op_category(name)] += 1
    lines = [f"{'category':28s} {'total_s':>10s} {'%':>6s} {'#ops':>6s}"]
    for cat, secs in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        lines.append(f"{cat:28s} {secs:10.4f} {100*secs/total:6.2f} "
                     f"{cat_n[cat]:6d}")
    lines.append("")
    lines.append(f"{'op':84s} {'total_s':>10s} {'%':>6s}")
    for name, secs in sorted(totals.items(), key=lambda kv: -kv[1])[:n]:
        lines.append(f"{name[:84]:84s} {secs:10.4f} {100*secs/total:6.2f}")
    lines.append(f"{'TOTAL':84s} {total:10.4f} {100.0:6.2f}")
    return "\n".join(lines)
