"""The output check's control at a size a test run holds. At the tiny
configurations the program runs its float32 paths, so a sound run reads
round-off; the float32 reference with every product's operands rounded to
float8, put in the program's place, reads a hundred times more on at least
one compared number. (At the cells' own sizes, in bfloat16, a run on the card of
`benchmark/control/precision.py` reads the control against the limits.)"""
from __future__ import annotations

import pytest

from benchmark.control import precision
from benchmark.tests.test_bench_run import CELLS, go, tiny


@pytest.mark.parametrize("workload", CELLS)
def test_float8_in_the_programs_place_separates(workload):
    sound = go(workload, seed=4)["checks"]
    for line in precision.main(["--workload", workload, "--seeds", "4", "2147483659"],
                               device="cpu", tweak=tiny):
        low = line["checks"]
        assert any(low[k]["value"] > max(100 * sound[k]["value"], 1e-3) for k in low), \
            (low, sound)


@pytest.mark.parametrize("workload", CELLS)
def test_float32_in_the_programs_place_reads_nothing(workload):
    """The reference against itself reads zero on every number."""
    line = precision.main(["--workload", workload, "--seeds", "4", "--precision", "fp32"],
                          device="cpu", tweak=tiny)[0]
    assert all(c["value"] == 0 for c in line["checks"].values()), line["checks"]


@pytest.mark.parametrize("workload", CELLS[:2])
def test_float8_in_the_trunk_alone_moves_the_latents(workload):
    """float8 operands in the DiT alone (the codec in float32): the sampler's
    latents read a hundred times the sound run's gap, and the speaker frames,
    which the codec alone makes, read nothing."""
    sound = go(workload, seed=4)["checks"]
    line = precision.main(["--workload", workload, "--seeds", "4", "--precision", "fp8-dit"],
                          device="cpu", tweak=tiny)[0]
    low = line["checks"]
    assert low["latent_rel_l2"]["value"] > max(100 * sound["latent_rel_l2"]["value"], 1e-3), low
    assert low["speaker_q25_gap"]["value"] == 0, low
