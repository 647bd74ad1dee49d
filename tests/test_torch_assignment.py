"""The port's assignment search (`ops/assignment.py`) against the JAX
package's, on the CPU.

`_subvolume_topk`: values and flat indices equal to JAX's (the same fp32
products; ties, including the -inf of masked entries, keep the lower flat
index first in both). `top_assignments` / `SimVolume`: the assignment lists
equal, on tests/test_assignment.py's cases, with negative similarities, a
single detection, and similarities with ties.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from instance_based_loc_tpu.ops import assignment as jas
from instance_based_loc_tpu_torch.ops import assignment as tas


def _aug(sims):
    aug = np.ones((sims.shape[0], sims.shape[1] + 1), np.float32)
    aug[:, :-1] = sims
    return aug


@pytest.mark.parametrize("k,topk,ties", [(1, 4, False), (2, 20, False),
                                         (3, 125, False), (3, 60, True)])
def test_subvolume_topk_matches_jax(k, topk, ties):
    rng = np.random.default_rng(k * 10 + topk)
    d, m = 4, 4
    sims = rng.uniform(-1.0, 1.0, size=(d, m)).astype(np.float32)
    if ties:                          # equal products in many entries
        sims = np.round(sims * 2) / 2
    rows = _aug(sims)[np.array([(0, 1, 2), (1, 2, 3), (0, 2, 3)])[:, :k]]
    valid = np.ones(m + 1, bool)
    valid[1] = False                  # a padded memory slot
    jv, ji = jas._subvolume_topk(jnp.asarray(rows), jnp.asarray(valid), k,
                                 topk)
    tv, ti = tas._subvolume_topk(torch.as_tensor(rows),
                                 torch.as_tensor(valid), k, topk)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


CASES = {
    "random_3x5": lambda rng: rng.uniform(0.1, 1.0, size=(3, 5)),
    "random_4x6": lambda rng: rng.uniform(0.1, 1.0, size=(4, 6)),
    "two_detections": lambda rng: rng.uniform(0.5, 1.0, size=(2, 3)),
    "argmax_row": lambda rng: np.array([[0.1, 0.9, 0.3]]),
    "single_detection": lambda rng: np.array([[0.3, 0.8]]),
    "negative": lambda rng: np.array([[-0.5, 0.2], [0.9, -0.1]]),
    "negative_wide": lambda rng: rng.uniform(-1.0, 1.0, size=(5, 7)),
    "ties": lambda rng: np.round(rng.uniform(0.0, 1.0, size=(4, 5)) * 3) / 3,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_top_assignments_match_jax(name):
    rng = np.random.default_rng(len(name))
    sims = CASES[name](rng).astype(np.float32)
    for size, per_len in ((3, 4), (2, 3)):
        ref = jas.top_assignments(sims, subvolume_size=size,
                                  num_per_length=per_len)
        got = tas.top_assignments(sims, subvolume_size=size,
                                  num_per_length=per_len, device="cpu")
        assert got == ref, (name, size, per_len)
    sv_j, sv_t = jas.SimVolume(sims), tas.SimVolume(sims, device="cpu")
    sv_j.fast_construct_volume(3)
    sv_t.fast_construct_volume(3)
    assert (sv_t.get_top_indices_from_subvolumes()
            == sv_j.get_top_indices_from_subvolumes())
    if name == "negative":
        assert [[0, 1], [1, 0]] in got
    if name in ("argmax_row", "single_detection"):
        assert got[0] == [[0, 1]]
