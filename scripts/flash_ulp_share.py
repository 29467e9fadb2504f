#!/usr/bin/env python3
"""How far flash attention's bf16 tensor-core instance lies from its plain
version, for the kernel source of any checkout, on one CUDA card.

    python3 scripts/flash_ulp_share.py [ROOT ...]

For each ROOT (a checkout of this repository; default: this one) the
script builds that checkout's ``flash_attention.cu`` into its own
``build/``, runs ``chip_smoke.py``'s phase-2 flash cases with that
checkout's kernel and prints, over the bf16 cases at head dims 64 and 128,
the share of output elements that differ from the plain version at all and
the largest distance in bf16 ulps, then times the kernel at
``chip_smoke.py``'s phase-4 layers (``phase_flash_timing``: the OLMo-1B
prefill layer, the three dense configs' and one ``prefill_32k`` layer).
Give two checkouts (e.g. an unpacked
parent commit and this one) to compare them on the same card; each ROOT
runs in a process of its own.  Prints the card's ``nvidia-smi`` name and
power limit and, last, one JSON object by ROOT.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def one(root: Path) -> dict:
    """The phase-2 flash cases with ``root``'s kernel (this process)."""
    sys.path.insert(0, str(HERE))
    import chip_smoke
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    if not Path(fa.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"flash_attention imported from {fa.__file__}, "
                           f"not from {root}")
    for line in build.build(fa.SOURCE).get(fa.SOURCE.name, "").splitlines():
        if any(w in line for w in ("registers", "spill", "arning")):
            print(f"  nvcc {fa.SOURCE.name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = chip_smoke.phase_flash_kernels(torch.device("cuda"),
                                         ulp_check=False)
    timing = chip_smoke.phase_flash_timing()
    return dict(out["wgmma"], source=str(fa.SOURCE),
                ms={label: row["ms"] for label, row in timing.items()})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_ulp_share: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(Path(sys.argv[2]))))
        return 0
    roots = [Path(r) for r in sys.argv[1:]] or [HERE]
    results = {}
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)],
                              capture_output=True, text=True, check=False)
        print(proc.stdout, end="")
        print(proc.stderr, end="", file=sys.stderr)
        if proc.returncode != 0:
            return proc.returncode
        results[str(root)] = json.loads(proc.stdout.strip().splitlines()[-1])
    import chip_smoke
    print(chip_smoke.card_line())
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    sys.exit(main())
