"""The reader of ``sv_fallback_split_share``: the share of the card's NW
cells whose lanes ran split over a cluster of CTAs, on hand-made
contexts."""

from __future__ import annotations

import pytest

from benchmark import harness

NAME = "sv_fallback_split_share.evidence"


def test_the_metric_is_in_the_manifest():
    m = {m["name"]: m for m in harness.manifest()["per_layer"]}[NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == \
        ("%", "higher", "program_counter", "kernels",
         "evidence_bases_per_s")
    assert m["workloads"] == ["evidence.hg002_45x", "evidence.chr21"]


@pytest.mark.parametrize("stats,want", [
    ({"fallback_cells": 4e9, "fallback_device_cells": 4e9,
      "fallback_split_cells": 3e9}, 75.0),
    ({"fallback_cells": 4e9, "fallback_device_cells": 2e9,
      "fallback_split_cells": 2e9}, 100.0),
    ({"fallback_cells": 4e9, "fallback_device_cells": 4e9,
      "fallback_split_cells": 0}, 0.0),
    # the card filled no NW cell in the window
    ({"fallback_cells": 4e9, "fallback_device_cells": 0,
      "fallback_split_cells": 0}, None),
    ({"fallback_cells": 0, "fallback_device_cells": 0,
      "fallback_split_cells": 0}, None),
    # a program without the counter (the parent of the split fill)
    ({"fallback_cells": 4e9, "fallback_device_cells": 4e9}, None),
    ({}, None),
])
def test_reader_on_a_hand_made_context(stats, want):
    got = harness.reader(NAME)(dict(spans={}, fill_stats=stats))
    assert got == (None if want is None else pytest.approx(want))
