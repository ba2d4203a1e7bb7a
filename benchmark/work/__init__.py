"""The work a call needs, and the least time the card could take for it.

One module a index family (``work/<family>.py``) counts, from shapes and
the data alone, the bytes a call must move (every input byte the work
needs read once, every output byte written once) and its useful
multiply-adds by operand type.  The count is the same whatever implements
the work, so fusing or replacing a kernel changes no count.  The arithmetic
is a frozen copy of ``chip_smoke.py::bound`` / ``probed_rows`` /
``k1_bounds``, with operations counted at the fastest published dense
rate for their operand type (fp32 operands at the TF32 tensor-core rate),
so that no implementation can read above 100%.  The table of peaks holds
every operand type a family may count (int8 for SQ8 codes), so that a
family added later finds its rate here.
"""

from __future__ import annotations

#: one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): device
#: memory bytes/s and operations/s by operand type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"tf32": 495e12, "bf16": 989e12, "fp16": 989e12,
              "fp8": 1979e12, "int8": 1979e12}
#: bytes of one (distance fp32, label int64) result
RESULT_BYTES = 12


def bound_s(nbytes: float, ops: dict) -> tuple[float, str]:
    """(seconds, "bytes" | "operations"): the larger of ``nbytes`` over
    the memory bandwidth and the operations over their types' peaks."""
    by_bytes = nbytes / HBM_BYTES_S
    by_ops = sum(n / PEAK_OPS_S[t] for t, n in ops.items())
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")
