"""The roofline's frozen counts match the transforms and the AIR slice that
a small proof of distaff_torch runs on the CPU.  (The test reads the port;
the counts in roofline/ do not.)"""

import pytest

import roofline
from conftest import SMALL_PROGRAM, SMALL_STEPS


@pytest.fixture(scope="module")
def recorded(monkeypatch_module):
    import distaff_torch
    from distaff_torch import ProgramInputs, ProofOptions, assembly
    from distaff_torch.ops import tiles
    from distaff_torch.stark.constraints import device_eval

    calls = {"transforms": [], "air": []}
    depth = [0]

    def wrap(name, transform):
        def recorded_transform(values, *args, **kwargs):
            depth[0] += 1
            try:
                out = transform(values, *args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:  # the caller's transform, not one it calls
                rows = values.shape[0] if values.dim() == 3 else 1
                calls["transforms"].append((rows, values.shape[-2], out.shape[-2]))
            return out
        monkeypatch_module.setattr(tiles, name, recorded_transform)

    for name in ("ntt", "ntt_batched", "intt", "intt_batched"):
        wrap(name, getattr(tiles, name))
    transition = device_eval.transition

    def recorded_transition(lde, tables):
        calls["air"].append(tuple(lde.shape[:2]))
        return transition(lde, tables)

    monkeypatch_module.setattr(device_eval, "transition", recorded_transition)
    program = assembly.compile(SMALL_PROGRAM)
    _, proof = distaff_torch.execute(program, ProgramInputs.from_public([1, 0]), 1,
                                     ProofOptions(), device="cpu")
    calls["registers"] = len(proof.trace_evaluations[0])
    calls["extension_factor"] = proof.options.extension_factor()
    return calls


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as patch:
        yield patch


def test_transforms_are_the_proofs(recorded):
    expected = [(rows, n_in, n_out) for _, rows, n_in, n_out in roofline.transforms(
        SMALL_STEPS, recorded["extension_factor"], recorded["registers"])]
    assert sorted(recorded["transforms"]) == sorted(expected)


def test_air_slice_is_the_proofs(recorded):
    assert recorded["air"] == [roofline.air_slice(SMALL_STEPS, recorded["registers"])]


def test_bytes_of_the_cells():
    """The cells' proofs: 20 registers, extension factor 32."""
    assert roofline.ntt_bytes(2**18, 32, 20) == 16 * (20 * (2 * 2**18 + 2**18 + 2**23)
                                                      + 3 * 2 * 2**21 + 2**21 + 2**23)
    assert roofline.air_bytes(2**16, 20) == 16 * 21 * 2**19
