"""The trace reduction (utils/xplane.py) on a small hand-encoded XSpace with
the layout a GPU trace has: kernel events on the "Stream #N(...)" lines of
"/device:GPU:0", host events on "/host:CPU"."""

import pytest

from pyspeedy_tpu.utils.xplane import device_op_totals


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(fno, value):
    if isinstance(value, int):
        return _varint(fno << 3) + _varint(value)
    value = value.encode() if isinstance(value, str) else value
    return _varint(fno << 3 | 2) + _varint(len(value)) + value


def _plane(name, lines, meta):
    body = _field(2, name)
    for line_name, events in lines:
        line = _field(2, line_name)
        for mid, dur_ps in events:
            line += _field(4, _field(1, mid) + _field(3, dur_ps))
        body += _field(3, line)
    for mid, op in meta.items():
        body += _field(4, _field(1, mid) + _field(2, _field(1, mid)
                                                  + _field(2, op)))
    return _field(1, body)


def test_device_op_totals_reads_gpu_stream_lines(tmp_path):
    run_dir = tmp_path / "plugins" / "profile" / "run1"
    run_dir.mkdir(parents=True)
    space = (_plane("/device:GPU:0",
                    [("Stream #13(Compute)", [(1, 2_000_000), (2, 500_000),
                                              (1, 1_000_000)]),
                     ("Stream #14(MemcpyD2H)", [(3, 250_000)])],
                    {1: "loop_fusion", 2: "gemm_fusion", 3: "MemcpyD2H"})
             + _plane("/host:CPU", [("python", [(1, 9_000_000)])],
                      {1: "PjitFunction"}))
    (run_dir / "host.xplane.pb").write_bytes(space)
    totals = device_op_totals(str(tmp_path))
    assert totals == pytest.approx({"loop_fusion": 3e-6, "gemm_fusion": 5e-7,
                                    "MemcpyD2H": 2.5e-7})
