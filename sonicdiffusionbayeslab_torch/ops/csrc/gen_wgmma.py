"""Write ``wgmma.cuh``: inline-PTX wrappers of Hopper's bf16 ``wgmma``.

Every accumulator register of a ``wgmma.mma_async`` is its own asm operand,
so each instruction width N needs its own operand list.  This script writes
them out; ``wgmma.cuh`` is its output, committed beside it, and
``tests/test_torch_kernels.py`` checks that the two agree.

    python sonicdiffusionbayeslab_torch/ops/csrc/gen_wgmma.py
"""

from __future__ import annotations

from pathlib import Path

HEADER = Path(__file__).with_name("wgmma.cuh")
SS_WIDTHS = (64, 128)  # S = Q.K^T: N = the K/V tile's rows
RS_WIDTHS = tuple(range(16, 161, 16))  # O += P.V: N = head_dim rounded up to 16


def _regs(first: int, count: int) -> str:
    return ", ".join(f"%{first + i}" for i in range(count))


def _outputs(n_regs: int) -> str:
    return ",\n        ".join(", ".join(f'"+f"(d[{i + j}])' for j in range(min(8, n_regs - i)))
                              for i in range(0, n_regs, 8))


def _ss(n: int) -> str:
    r = n // 2
    return f"""
template <> struct Wgmma<{n}> {{
  // d[{r}] += A (64x16, smem, K-major) * B ({n}x16, smem, K-major)^T
  static __device__ __forceinline__ void ss(float (&d)[{r}], uint64_t da, uint64_t db, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{_regs(0, r)}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"
        : {_outputs(r)}
        : "l"(da), "l"(db), "r"(scale_d));
  }}
"""


def _rs(n: int) -> str:
    r = n // 2
    return f"""  // d[{r}] += A (64x16, registers) * B (16x{n}, smem, MN-major: transposed)
  static __device__ __forceinline__ void rs(float (&d)[{r}], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{_regs(0, r)}}}, {{{_regs(r, 4)}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"
        : {_outputs(r)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }}
"""


def render() -> str:
    parts = [
        "// Generated by gen_wgmma.py: do not edit by hand.\n"
        "// Wgmma<N>::ss: bf16 wgmma m64nNk16, A and B from shared memory, both K-major.\n"
        "// Wgmma<N>::rs: bf16 wgmma m64nNk16, A from registers, B from shared memory\n"
        "// MN-major (the transpose bit).  fp32 accumulators d[N/2] per thread; the\n"
        "// products are asynchronous: fence, commit and wait around them.\n"
        "#pragma once\n#include <stdint.h>\n\ntemplate <int N> struct Wgmma;\n"
    ]
    for n in sorted(set(SS_WIDTHS) | set(RS_WIDTHS)):
        body = _ss(n) if n in SS_WIDTHS else f"\ntemplate <> struct Wgmma<{n}> {{\n"
        parts.append(body + (_rs(n) if n in RS_WIDTHS else "") + "};\n")
    return "".join(parts)


if __name__ == "__main__":
    HEADER.write_text(render())
