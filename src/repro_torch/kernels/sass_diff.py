"""Compare two builds of a kernel library, kernel by kernel, in SASS.

    python -m repro_torch.kernels.sass_diff OLD.so NEW.so [--drop TOKEN ...]

Runs the CUDA toolkit's ``cuobjdump -sass`` on both shared libraries,
splits each listing into its kernels, and compares the instructions of
every kernel the two share, their addresses and encodings left out.
``--drop`` removes a token from the mangled names before they are paired,
so a kernel whose template gained an argument still pairs with its earlier
build (``Lb1E`` is a ``true`` bool argument).  Prints the count of shared
and identical kernels and each kernel that differs; exits 1 when one does.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from typing import Sequence

from ._build import find_nvcc

_FUNCTION = re.compile(r"Function : (\S+)")
_COMMENT = re.compile(r"/\*.*?\*/")


def parse_sass(listing: str, drop: Sequence[str] = ()) -> dict[str, list[str]]:
    """Each kernel's instructions in a ``cuobjdump -sass`` listing, under
    its mangled name with every ``drop`` token removed."""
    kernels: dict[str, list[str]] = {}
    name = None
    for line in listing.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            for token in drop:
                name = name.replace(token, "")
            kernels[name] = []
        elif name is not None and "/*" in line:
            ins = _COMMENT.sub("", line).strip()
            if ins:
                kernels[name].append(ins)
    return kernels


def compare(old: dict[str, list[str]], new: dict[str, list[str]]
            ) -> tuple[list[str], list[str]]:
    """The kernels both builds have, and those of them whose instructions
    differ."""
    shared = sorted(set(old) & set(new))
    return shared, [n for n in shared if old[n] != new[n]]


def _sass(path: str) -> str:
    cuobjdump = find_nvcc().removesuffix("nvcc") + "cuobjdump"
    return subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("old")
    parser.add_argument("new")
    parser.add_argument("--drop", action="append", default=[])
    args = parser.parse_args(argv)
    shared, differ = compare(parse_sass(_sass(args.old), args.drop),
                             parse_sass(_sass(args.new), args.drop))
    print(f"{args.old} vs {args.new}: {len(shared)} shared kernels, "
          f"{len(shared) - len(differ)} identical")
    for name in differ:
        print(f"  differs: {name}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
