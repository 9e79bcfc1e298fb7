"""Whether the kernels compile to the same machine code in two trees.

    python -m peba1_tpu_torch.sass_diff build/parent                  # every csrc/*.cu
    python -m peba1_tpu_torch.sass_diff build/parent cmux_step_gen fused_blind_rotate
    python -m peba1_tpu_torch.sass_diff build/parent rotate_decompose=cmux_step

Compiles the named ``csrc/<stem>.cu`` (by default every source of this
tree) of this tree and of another checkout with the flags of
``ops/cuda_kernels.NVCC_FLAGS``, disassembles both with ``cuobjdump -sass``
and compares each kernel's instructions (addresses, encodings and the
anonymous namespace, which names the file, left out).  ``ours=theirs``
compares this tree's ``csrc/ours.cu`` with the other's ``csrc/theirs.cu``,
for a kernel that moved to another source.  Prints one line per kernel of
this tree and exits non-zero if any differs or is missing there.  Needs
the CUDA toolkit, not a card.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

from .ops.cuda_kernels import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc


def sass(root: str, stem: str, tag: str) -> "dict[str, list[str]]":
    """{kernel name: instructions} of `root`'s csrc/<stem>.cu, built as
    build/sass/<tag>_<stem>.so."""
    out = BUILD_DIR / "sass" / f"{tag}_{stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(out),
                    str(Path(root) / "peba1_tpu_torch" / "csrc" / f"{stem}.cu")],
                   check=True, capture_output=True)
    cuobjdump = str(Path(nvcc).resolve().with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(out)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            # The length prefix too: it counts the file name's characters.
            name = re.sub(r"\d*_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "ANON", m.group(1))
            funcs[name] = []
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            funcs[name].append(line.split(";")[0].split("*/", 1)[1].strip())
    return funcs


def main() -> None:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    here = str(Path(__file__).resolve().parent.parent)
    stems = sys.argv[2:] or sorted(src.stem for src in CSRC.glob("*.cu"))
    same = True
    for pair in stems:
        stem, _, their_stem = pair.partition("=")
        their_stem = their_stem or stem
        if not (Path(sys.argv[1]) / "peba1_tpu_torch" / "csrc" / f"{their_stem}.cu").exists():
            print(f"{pair}: no csrc/{their_stem}.cu in {sys.argv[1]}")
            same = False
            continue
        theirs, ours = sass(sys.argv[1], their_stem, "theirs"), sass(here, stem, "ours")
        for name, ins in ours.items():
            equal = theirs.get(name) == ins
            same &= equal
            print(f"{pair}: {name}: {'identical' if equal else 'DIFFERS'} "
                  f"({len(ins)} instructions here, {len(theirs.get(name, []))} there)")
        gone = sorted(set(theirs) - set(ours))
        if gone:
            print(f"{pair}: only in {sys.argv[1]}: {', '.join(gone)}")
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
