"""The reference catches one flipped byte and a misordered batch."""

from __future__ import annotations

import torch

from portbench import data, reference

CPU = torch.device("cpu")


def _flipped(t: torch.Tensor, i: int) -> torch.Tensor:
    t = t.clone()
    t.reshape(-1).view(torch.uint8)[i] ^= 1
    return t


def test_one_flipped_byte_in_a_tree():
    want = data.ckpt_tree(2000, 13, 3, CPU)
    got = {k: v.clone() for k, v in want.items()}
    assert reference.same_tree(got, want, CPU)
    for name in want:
        for i in (0, want[name].numel() * want[name].element_size() - 1):
            bad = dict(got, **{name: _flipped(got[name], i)})
            assert not reference.same_tree(bad, want, CPU)


def test_dtype_shape_and_names_count():
    want = data.ckpt_tree(2000, 13, 3, CPU)
    got = dict(want, model=want["model"].view(torch.int16))
    assert not reference.same_tree(got, want, CPU)
    got = dict(want, params=want["params"].reshape(2, 1000))
    assert not reference.same_tree(got, want, CPU)
    assert not reference.same_tree({k: want[k] for k in list(want)[1:]},
                                   want, CPU)


def test_one_flipped_byte_in_a_sample():
    want = data.random_bytes(70_001, 9, "sample0", CPU)
    assert reference.same_bytes(want.clone(), want)
    assert not reference.same_bytes(_flipped(want, 70_000), want)
    assert not reference.same_bytes(want[:-1], want)


def test_a_misordered_batch_is_caught():
    """Samples of one size, so that only their bytes tell them apart."""
    files = [data.random_bytes(4096, 4, f"sample{f}", CPU) for f in range(8)]
    order = data.permutation(8, 11, "epoch0")
    batches = [[files[f] for f in order[i * 2:(i + 1) * 2]] for i in range(4)]
    landed = batches[:1] + [batches[2], batches[1]] + batches[3:]
    same = [all(reference.same_bytes(got, want)
                for got, want in zip(batch, batches[i]))
            for i, batch in enumerate(landed)]
    assert same == [True, False, False, True]
