"""Proving over a mesh of slots: the port of distaff_tpu/parallel/.

mesh.py holds the mesh (slots, each a device and, on a card, a stream of
its own), values split over its slots and the copies between them;
ntt_sharded.py the four-step transform split over the slots; and
mesh_stages.py the prover's stages on the slots' shares.
"""
