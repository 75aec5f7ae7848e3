"""Program inputs: public stack initialization + two secret input tapes
(reference src/programs/inputs.rs)."""

from ..config import MAX_PUBLIC_INPUTS


class ProgramInputs:
    def __init__(self, public=(), secret_a=(), secret_b=()):
        assert len(public) <= MAX_PUBLIC_INPUTS, (
            f"expected no more than {MAX_PUBLIC_INPUTS} public inputs, "
            f"but received {len(public)}"
        )
        assert len(secret_a) >= len(secret_b), (
            "number of primary secret inputs cannot be smaller than the number "
            "of secondary secret inputs"
        )
        self.public = list(public)
        self.secret = [list(secret_a), list(secret_b)]

    @staticmethod
    def none():
        return ProgramInputs()

    @staticmethod
    def from_public(public):
        return ProgramInputs(public)

    def get_public_inputs(self):
        return self.public

    def get_secret_inputs(self):
        return self.secret
