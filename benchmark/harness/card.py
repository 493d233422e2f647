"""The card a run is on, and the modules a run must never load."""
from __future__ import annotations

import subprocess
import sys
from typing import List

# top-level module names (before the first dot, compared whole): JAX and
# the JAX package this port was made from; `echo_tts_tpu_torch` is allowed
FORBIDDEN = ("jax", "jaxlib", "flax", "echo_tts_tpu")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
