"""Native Needleman-Wunsch identity (native/nw.cpp) vs the python DP oracle."""

import numpy as np
import pytest

from mindthegap_tpu.ops import nw


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(3)

    def rand_seq(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    out = []
    for _ in range(10):
        n = int(rng.integers(5, 180))
        a = rand_seq(n)
        if rng.random() < 0.5:
            b = list(a)
            for _ in range(int(rng.integers(0, 8))):
                p = int(rng.integers(0, len(b)))
                r = rng.random()
                if r < 0.4:
                    b[p] = rng.choice(list("ACGT"))
                elif r < 0.7:
                    b.insert(p, rng.choice(list("ACGT")))
                else:
                    del b[p]
            b = "".join(b)
        else:
            b = rand_seq(int(rng.integers(5, 180)))
        out.append((a, b))
    return out


def test_native_matches_oracle(pairs):
    if nw._load_native() is None:
        pytest.skip("native NW unavailable")
    py = [nw.needleman_wunsch(a, b)[0] for a, b in pairs]
    nat = [nw.nw_identity(a, b) for a, b in pairs]
    np.testing.assert_allclose(nat, py, rtol=0, atol=1e-12)
