"""The system under test, driven as its users drive it: distaff_torch's
execute() on the cell's program, one statement after another, each proof
serialized to the bytes a client receives.

Set-up compiles the program once and proves one warm statement of the
cell's own size (it builds or loads every library the proof launches and
the power tables); the window then proves fresh statements back to back
for the run's seconds, and completes and counts the proof in flight when
time runs out.
"""

import time


class Request:
    """One request of the window: what it asked, what it got, and when."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.start = self.end = None
        self.outputs = self.proof = None
        self.pow_nonce = None
        self.steps = {}

    @property
    def seconds(self):
        return self.end - self.start


class System:
    """The cell's program and options on distaff_torch, proving on `device`."""

    def __init__(self, config, device):
        import distaff_torch
        from distaff_torch import ProgramInputs, ProofOptions, assembly
        from distaff_torch.stark import serde

        self._execute = distaff_torch.execute
        self._inputs = ProgramInputs.from_public
        self._serialize = serde.serialize
        self.device = device
        self.num_outputs = config["num_outputs"]
        self.options = ProofOptions(**config["options"])
        self.program = assembly.compile(config["program"])

    def prove(self, request):
        """execute() the request's statement and serialize its proof."""
        outputs, proof = self._execute(self.program, self._inputs(request.inputs),
                                       self.num_outputs, self.options, device=self.device)
        request.outputs = [int(v) for v in outputs]
        request.proof = self._serialize(proof)
        request.pow_nonce = int(proof.pow_nonce)


def run_window(system, traffic, seconds, synchronize, hooks=None):
    """Proves the traffic's statements back to back until `seconds` have
    passed, completing the last; returns (requests, window seconds).  The
    window ends when the device has finished (`synchronize`).  `hooks`
    (trace.StepSpans) hears each request's start and end."""
    requests = []
    start = time.perf_counter()
    for inputs in traffic.requests():
        request = Request(inputs)
        if hooks:
            hooks.begin(request)
        request.start = time.perf_counter()
        system.prove(request)
        request.end = time.perf_counter()
        if hooks:
            hooks.end(request)
        requests.append(request)
        if request.end - start >= seconds:
            break
    synchronize()
    return requests, time.perf_counter() - start
