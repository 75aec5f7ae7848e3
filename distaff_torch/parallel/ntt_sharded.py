"""Distributed NTT: the four-step Cooley-Tukey decomposition over a mesh,
the port of distaff_tpu/parallel/ntt_sharded.py.

For n = n1 * n2 with the i1 axis split over the slots:

    X[k2 + n2*k1] = NTT_n1 over i1 ( w^(i1*k2) * NTT_n2 over i2 ( x[i1 + n1*i2] ) )

- step 1: length-n2 NTTs along each slot's rows i1, one K1 pass whose
  store multiplies by the twiddle w^(i1*k2) with the slot's *global* i1
  (the pass's first column, ops/field_kernels.ntt_pass), from the power
  tables of w that the single-device transform keeps (ops/tiles);
- step 2: the distributed transpose: each slot sends its columns k2 of
  slot t's share to slot t (the all-to-all, as copies, parallel/mesh.py);
- step 3: the length-n1 NTTs along the now-local axis i1, one K1 pass, its
  store writing [k1][k2] so that the shares the next readers take are
  whole blocks (above K1's leaf, ops/tiles' recursion and a transpose).

The result, Out[k1, k2] with the k2 axis split (the JAX package's
out_specs), is the natural-order transform read row-major.  Where the JAX
package re-replicates it (the reshape to (n, 4)), `gather` brings it to the
home slot (in a multi-process job, to every rank's); where the next
reader wants it split by rows, `columns_to_rows` lays it out so (one more
all-to-all).  A transform of several rows at
once (B, n, 4) runs them together.  The inverse folds 1/n into step 1's
store factors, as ops/tiles does.
"""

from ..math import field
from ..ops import field_kernels as fk
from ..ops import tiles
from .mesh import Sharded

M = field.M


def _split(n):
    """n = n1 * n2, both powers of two, as K1's four-step splits it
    (ops/tiles._split): the JAX package's n1 <= n2 up to 2^22 points; above,
    n2 stays at K1's leaf, so that step 1 is one pass."""
    return tiles._split(n, tiles.LEAF)


def fits(n, mesh):
    """Whether a transform of n points splits over the mesh: the slots
    divide n1 and n2."""
    n1, n2 = _split(n)
    k = mesh.size
    return n >= 4 and k & (k - 1) == 0 and n1 % k == 0 and n2 % k == 0


def transform_keys(n, root_int, c_int, device):
    """The power-table keys of a sharded transform of n points at root_int
    times c_int, on one device: step 1's twiddles and store factors (those
    of the whole transform) and step 3's twiddles."""
    n1, n2 = _split(n)
    root1 = pow(int(root_int), n2, M)
    return [tiles.factors_key(n, root_int, c_int, device),
            tiles.twiddle_key(n2, pow(int(root_int), n1, M), device)] + (
        [tiles.twiddle_key(n1, root1, device)] if n1 <= tiles.LEAF
        else tiles.ntt_keys(n1, root1, device))


def ntt_keys(n, root_int, mesh):
    """The keys of ntt_sharded's tables at n points on every card of the mesh."""
    return [key for d in mesh.devices() for key in transform_keys(n, root_int, 1, d)]


def intt_keys(n, root_int, mesh):
    """The keys of intt_sharded's tables at n points on every card of the mesh."""
    inv_root = pow(int(root_int), n - 1, M)
    return [key for d in mesh.devices() for key in transform_keys(n, inv_root, field.inv(n), d)]


def transform(x, mesh, root_int, n, c_int=1):
    """c * the natural-order NTT of size n (root_int a primitive n-th root of
    unity) of each row of x: (B, n_in, 4) limbs on the home device, zero
    extended from n_in to n points, or a Sharded of (B, n/k, 4) rows.
    Returns Out split by its k2 axis: slot t holds (B, n1, n2/k, 4), Out[b,
    k1, t n2/k + j] = X[b, t n2/k + j + n2 k1]."""
    if not fits(n, mesh):
        raise ValueError(f"ntt_sharded: {n} points do not split over {mesh.size} slots")
    k = mesh.size
    n1, n2 = _split(n)
    c, w = n1 // k, n2 // k
    root_int, c_int = int(root_int), int(c_int)
    if not isinstance(x, Sharded):
        x = x.contiguous()          # on the caller's stream, before the slots fork from it
    with mesh.stage():
        # the slots' inputs, (B, P, c, 4): rows i2 < P of their columns i1
        if isinstance(x, Sharded):
            if x.axis != "rows" or x.share() * k != n:
                raise ValueError(f"ntt_sharded: a {x.axis} split of {x.share() * k} points")
            batch, points = x.parts[0].shape[0], n2
            ins = [mesh.empty(s, (batch, points, c, 4)) for s in range(k)]
            with mesh.exchange():
                for u, part in enumerate(x.parts):
                    block = part.view(batch, w, n1, 4)
                    for s in range(k):
                        mesh.copy_(ins[s][:, u * w:(u + 1) * w], s,
                                   block[:, :, s * c:(s + 1) * c], u)
        else:
            batch, n_in = x.shape[0], x.shape[1]
            if n_in > n:
                raise ValueError(f"ntt_sharded: {n_in} points into a transform of {n}")
            points = -(-n_in // n1)
            if points * n1 != n_in:
                with mesh.slots[mesh.home_index].run():
                    padded = x.new_zeros((batch, points * n1, 4))
                    padded[:, :n_in] = x
                x = padded
            block = x.view(batch, points, n1, 4)
            ins = [mesh.empty(s, (batch, points, c, 4)) for s in range(k)]
            for s in range(k):
                mesh.from_home(ins[s], s, block[:, :, s * c:(s + 1) * c])

        # step 1 and its twiddles: (B, n2, c, 4) [k2][i1] on each slot
        def step1(slot, src):
            device = slot.device
            lo, hi = tiles._store_factors(n, root_int, c_int, device)
            dst = mesh.empty(slot.index, (batch, n2, c, 4))
            fk.ntt_pass(src, dst, tiles._stage_twiddles(n2, pow(root_int, n1, M), device),
                        batch, c, (points * c, 1, c), (n2 * c, 1, c), points * c, lo, hi,
                        first=slot.index * c)
            return dst

        rows = mesh.each(step1, ins)
        del ins

        # the transpose: slot t takes the columns k2 of its share from each slot
        cols = [mesh.empty(t, (batch, w, n1, 4)) for t in range(k)]
        with mesh.exchange():
            for s, part in enumerate(rows):
                for t in range(k):
                    mesh.copy_(cols[t][:, :, s * c:(s + 1) * c], t, part[:, t * w:(t + 1) * w],
                               s)
        del rows

        # step 3: (B, n1, w, 4) [k1][k2] on each slot
        root1 = pow(root_int, n2, M)

        def step3(slot, src):
            dst = mesh.empty(slot.index, (batch, n1, w, 4))
            if n1 <= tiles.LEAF:
                fk.ntt_pass(src, dst, tiles._stage_twiddles(n1, root1, slot.device),
                            batch, w, (w * n1, n1, 1), (n1 * w, 1, w), w * n1)
            else:
                done = tiles.ntt_batched(src.view(batch * w, n1, 4), root1)
                dst.copy_(done.view(batch, w, n1, 4).transpose(1, 2))
            return dst

        out = mesh.each(step3, cols)
    return Sharded(mesh, out, 2, "columns")


def gather(columns, n):
    """A transform's result (transform's) as (B, n, 4) on the home device."""
    mesh = columns.mesh
    n1, n2 = _split(n)
    w = n2 // mesh.size
    batch = columns.parts[0].shape[0]
    out = mesh.empty(mesh.home_index, (batch, n, 4))
    grid = out.view(batch, n1, n2, 4)
    with mesh.stage(), mesh.exchange():
        for t, part in enumerate(columns.parts):
            mesh.to_home(grid[:, :, t * w:(t + 1) * w], part, t)
    return out


def columns_to_rows(columns, n):
    """A transform's result (transform's) split by rows: slot u holds the
    points [u n/k, (u + 1) n/k), (B, n/k, 4)."""
    mesh = columns.mesh
    k = mesh.size
    n1, n2 = _split(n)
    c, w = n1 // k, n2 // k
    batch = columns.parts[0].shape[0]
    parts = [mesh.empty(u, (batch, n // k, 4)) for u in range(k)]
    with mesh.stage(), mesh.exchange():
        for t, part in enumerate(columns.parts):
            for u in range(k):
                mesh.copy_(parts[u].view(batch, c, n2, 4)[:, :, t * w:(t + 1) * w], u,
                           part[:, u * c:(u + 1) * c], t)
    return Sharded(mesh, parts, 1, "rows")


# the layout of the most recent transform's output before its gather (the
# JAX package's out.sharding): (axis, the slots' devices)
LAST_SHARDING = None


def _transform_one(x, mesh, root_int, c_int):
    global LAST_SHARDING
    n = x.shape[0]
    columns = transform(x[None], mesh, root_int, n, c_int)
    LAST_SHARDING = (columns.axis, mesh.names())
    return gather(columns, n)[0]


def ntt_sharded(x, mesh, root_int=None):
    """Natural-order NTT of (n, 4) limbs distributed over `mesh`; the result
    on the home device."""
    n = x.shape[0]
    if root_int is None:
        root_int = field.get_root_of_unity(n)
    return _transform_one(x, mesh, root_int, 1)


def intt_sharded(x, mesh, root_int=None):
    """Inverse transform: the sharded NTT with the inverse root, 1/n on its
    first pass's store."""
    n = x.shape[0]
    if root_int is None:
        root_int = field.get_root_of_unity(n)
    return _transform_one(x, mesh, pow(int(root_int), n - 1, M), field.inv(n))
