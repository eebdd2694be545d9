"""Read a hand-written kernel source's sizes on the CPU, where it cannot
be built: the Python launch plans (tpudl_torch.ops.norms.bwd_plan,
tpudl_torch.ops.quant_dot.gemm_plan) are held to the sizes their kernels
were compiled with, so a mismatch shows here and not first at a launch
on the card."""

import re
from typing import Dict

from tpudl_torch.ops import _build


def csrc_constants(name: str) -> Dict[str, int]:
    """``constexpr int NAME = <expression>;`` of ``csrc/<name>.cu``, each
    expression evaluated over the constants before it (integer literals,
    names, + - * / and parentheses only)."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    found: Dict[str, int] = {}
    for m in re.finditer(r"constexpr\s+int\s+(\w+)\s*=\s*([\w\s+\-*/()]+);",
                         text):
        expr = re.sub(r"\b(\w+)\b", lambda w: str(found.get(w.group(1),
                                                            w.group(1))),
                      m.group(2))
        if re.fullmatch(r"[\d\s+\-*/()]+", expr):
            found[m.group(1)] = int(eval(expr.replace("/", "//")))
    return found
