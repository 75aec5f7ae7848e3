"""The plain reference accepts distaff_torch's proofs and rejects each kind
of tampering that the benchmark's check must catch."""

import hashlib

import pytest

import reference
from reference.stark import serde

GOLDEN_SHA256 = "876d9f49cddbe11a3b360c04245d3b29712b6309a1eb446af835b123c729c842"
GOLDEN_LEN = 12926


def _check(case, blob=None, inputs=None, outputs=None, program_hash=None, options=None):
    source, case_inputs, case_outputs, proof, case_options = case
    return reference.check_proof(
        proof if blob is None else blob,
        reference.program_hash(source) if program_hash is None else program_hash,
        case_inputs if inputs is None else inputs,
        case_outputs if outputs is None else outputs,
        reference.ProofOptions(**(case_options if options is None else options)))


def _flip(data, index=0):
    return data[:index] + bytes([data[index] ^ 1]) + data[index + 1:]


def test_golden_transcript_is_accepted(small_proofs):
    blob = small_proofs["golden"][3]
    assert len(blob) == GOLDEN_LEN
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_SHA256
    assert _check(small_proofs["golden"]) is None


@pytest.mark.parametrize("case", ["fib", "golden"])
def test_proofs_of_the_port_are_accepted(small_proofs, case):
    assert _check(small_proofs[case]) is None


@pytest.mark.parametrize("case", ["fib", "golden"])
def test_proof_bytes_round_trip(small_proofs, case):
    blob = small_proofs[case][3]
    assert serde.serialize(serde.deserialize(blob)) == blob


def _tampered(blob, change):
    proof = serde.deserialize(blob)
    change(proof)
    return serde.serialize(proof)


def _flip_trace_root(p):
    p.trace_root = _flip(p.trace_root)


def _flip_trace_opening(p):
    p.trace_evaluations[0][0] ^= 1


def _flip_trace_node(p):
    nodes = next(n for n in p.trace_nodes if n)
    nodes[0] = _flip(nodes[0])


def _flip_constraint_opening(p):
    p.constraint_proof_obj.values[0] = _flip(p.constraint_proof_obj.values[0])


def _flip_fri_layer_value(p):
    p.degree_proof.layers[0].values[0][1] ^= 1


def _flip_fri_layer_root(p):
    p.degree_proof.layers[-1].root = _flip(p.degree_proof.layers[-1].root)


def _flip_remainder(p):
    p.degree_proof.rem_values[3] ^= 1


def _flip_deep_value(p):
    p.deep_values.trace_at_z1[2] ^= 1


def _change_nonce(p):
    p.pow_nonce += 1


TAMPERING = [_flip_trace_root, _flip_trace_opening, _flip_trace_node, _flip_constraint_opening,
             _flip_fri_layer_value, _flip_fri_layer_root, _flip_remainder, _flip_deep_value,
             _change_nonce]


@pytest.mark.parametrize("change", TAMPERING, ids=lambda f: f.__name__.lstrip("_"))
def test_tampered_proof_is_rejected(small_proofs, change):
    case = small_proofs["fib"]
    assert _check(case, blob=_tampered(case[3], change)) is not None


def test_flipped_byte_anywhere_in_the_bytes_is_rejected(small_proofs):
    case = small_proofs["fib"]
    blob = case[3]
    for index in (0, len(blob) // 3, len(blob) // 2, len(blob) - 1):
        assert _check(case, blob=_flip(blob, index)) is not None


def test_wrong_output_is_rejected(small_proofs):
    case = small_proofs["fib"]
    assert _check(case, outputs=[(case[2][0] + 1) % reference.interpreter.M]) is not None


def test_wrong_inputs_are_rejected(small_proofs):
    case = small_proofs["fib"]
    assert _check(case, inputs=[case[1][0], case[1][1] + 1]) is not None


def test_wrong_program_hash_is_rejected(small_proofs):
    case = small_proofs["fib"]
    other = reference.program_hash("begin repeat.13 swap dup.2 drop add end end")
    assert _check(case, program_hash=other) is not None
    assert _check(case, program_hash=_flip(reference.program_hash(case[0]))) is not None


def test_weaker_options_are_rejected(small_proofs):
    """A proof made under other options than the stated ones: the control's
    failure (a 19-bit proof of work where 20 bits are stated)."""
    case = small_proofs["fib"]
    assert _check(case, options={"grinding_factor": 21}) is not None
    assert _check(case, options={"num_queries": 49}) is not None


def test_program_hash_and_outputs_agree_with_the_port(small_proofs):
    """The reference's program hash and stack machine against the port's
    assembler and VM, for the cases' programs and the cells' own."""
    from distaff_torch import assembly

    for source, inputs, outputs, _, _ in small_proofs.values():
        assert reference.program_hash(source) == assembly.compile(source).hash
        assert reference.run_program(source, inputs, 1) == outputs


def test_interpreter_counts_fibonacci():
    source = "begin repeat.12 swap dup.2 drop add end end"
    assert reference.run_program(source, [1, 0], 1) == [233]
    with pytest.raises(ValueError):
        reference.run_program("begin rescr end", [], 1)
