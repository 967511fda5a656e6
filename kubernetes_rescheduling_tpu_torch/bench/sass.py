"""The machine code of a kernel library, counted by opcode.

    python -m kubernetes_rescheduling_tpu_torch.bench.sass score [--out FILE]

Builds ``ops/csrc/<name>.cu`` (as the kernels build at first use), runs
``cuobjdump -sass`` on the library, writes the full listing to ``--out``
(default: ``chiprun_out/sass_<name>.txt`` under the current directory) and
prints one JSON object: per kernel function, its instruction count and its
opcodes counted by base name (``MUFU.RCP`` and ``MUFU.LG2`` apart, as they
bound the score body). The score kernels' bound in ``chip_smoke.py``
(``score_bound``) counts the division and logarithm sequences of this
listing. Needs the CUDA toolkit (``cuobjdump`` beside ``nvcc``), not a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
from pathlib import Path

from kubernetes_rescheduling_tpu_torch.ops import _build

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z0-9_.]+)")


def opcode(mnemonic: str) -> str:
    """``MUFU.RCP`` and ``MUFU.LG2`` keep their function; other opcodes are
    counted by base name (``FFMA.RZ`` → ``FFMA``)."""
    return mnemonic if mnemonic.startswith("MUFU") else mnemonic.split(".")[0]


def census(listing: str) -> dict[str, dict]:
    """Per function of a ``cuobjdump -sass`` listing: instruction count and
    opcode histogram, largest first."""
    out: dict[str, collections.Counter] = {}
    func = None
    for line in listing.splitlines():
        m = _FUNC.match(line)
        if m:
            func = m.group(1)
            out[func] = collections.Counter()
            continue
        m = _INSN.match(line)
        if m and func is not None:
            out[func][opcode(m.group(1))] += 1
    return {f: {"instructions": sum(c.values()), "opcodes": dict(c.most_common())}
            for f, c in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", choices=_build.SOURCES)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    _build.build((args.name,))
    nvcc = Path(_build._nvcc())
    tool = shutil.which("cuobjdump") or str(nvcc.with_name("cuobjdump"))
    listing = subprocess.run([tool, "-sass", str(_build._target(args.name))], check=True,
                             capture_output=True, text=True, timeout=300).stdout
    out = args.out or Path("chiprun_out") / f"sass_{args.name}.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(listing)
    print(json.dumps({"library": args.name, "listing": str(out), "functions": census(listing)}))


if __name__ == "__main__":
    main()
