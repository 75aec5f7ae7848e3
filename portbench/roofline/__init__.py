"""The yardstick of the kernels' roofline shares: the card's published peak
and the bytes that a proof's work must move, from its geometry alone.

A proof of n trace steps with extension factor e over R registers works on
the LDE domain of N = e n points and the constraint evaluation domain of
8 n points (the AIR's largest constraint degree is 8).  Its work, counted
as the least bytes it must move once (16 bytes a field element), is

- the transforms (kernel K1): each input element read once and each output
  element written once, for step 1's interpolation of the R registers
  (n -> n points) and their extension (n coefficients -> N points), step
  4's interpolation of the three constraint columns (8 n -> 8 n) and step
  5's extension of the constraint polynomial (8 n coefficients -> N);
- the AIR's transition slice (kernel K4): the R registers over the 8 n
  points of the evaluation domain read once, its one combined column
  written once.

No count of the port's own (its multiplies, instructions or passes) enters
here, and no table of twiddles or powers: a design may compute those on the
fly, so the bytes above are a floor for any implementation.  The H100 does
not publish a 32-bit integer rate, so no operation bound is used.
"""

ELEMENT_BYTES = 16
MAX_CONSTRAINT_DEGREE = 8

# published peak of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet), bytes a second
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}


def peak_bytes_per_s(kind):
    """The card's published memory bandwidth; KeyError for a card not in the table."""
    return PEAKS[kind]["hbm_bytes_per_s"]


def transforms(n, extension_factor, registers):
    """The transforms of one proof as (name, rows, points in, points out)."""
    lde = n * extension_factor
    n_ev = n * MAX_CONSTRAINT_DEGREE
    return [
        ("trace interpolation", registers, n, n),
        ("trace extension", registers, n, lde),
        ("constraint interpolation", 3, n_ev, n_ev),
        ("constraint extension", 1, n_ev, lde),
    ]


def ntt_bytes(n, extension_factor, registers):
    """Least bytes that one proof's transforms move."""
    return ELEMENT_BYTES * sum(rows * (n_in + n_out)
                               for _, rows, n_in, n_out in transforms(n, extension_factor, registers))


def air_slice(n, registers):
    """The AIR's transition slice of one proof: (rows read, points)."""
    return registers, n * MAX_CONSTRAINT_DEGREE


def air_bytes(n, registers):
    """Least bytes that one proof's AIR transition moves: R rows read and
    one row written over the evaluation domain."""
    rows, points = air_slice(n, registers)
    return ELEMENT_BYTES * (rows + 1) * points
