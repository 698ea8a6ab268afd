"""`repro_torch.serve.faults.corrupt_tile_cache` against `repro`'s: the
same artifact mangled by each mode and seed leaves the same bytes."""
from __future__ import annotations

import json

import pytest

from repro.serve import faults as jfaults
from repro_torch.serve import faults as tfaults

ARTIFACT = {f"input_grad|b4|n8x8|row{i}": {"tile": i, "splits": 2 * i}
            for i in range(5)}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("mode", ["truncate", "garbage", "torn_row"])
@pytest.mark.parametrize("start", ["artifact", "absent"])
def test_corrupt_tile_cache_writes_repros_bytes(tmp_path, mode, seed,
                                                start):
    paths = []
    for side, corrupt in (("repro", jfaults.corrupt_tile_cache),
                          ("port", tfaults.corrupt_tile_cache)):
        p = tmp_path / f"{side}.json"
        if start == "artifact":
            p.write_text(json.dumps(ARTIFACT, indent=2))
        corrupt(p, mode, seed=seed)
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_corrupt_tile_cache_rejects_an_unknown_mode(tmp_path):
    with pytest.raises(ValueError, match="unknown corruption mode"):
        tfaults.corrupt_tile_cache(tmp_path / "c.json", "shred")
