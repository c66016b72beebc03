"""Orbax checkpoints without orbax: the directory layout that
``orbax.checkpoint.PyTreeCheckpointer`` (0.11) writes with its defaults, an
OCDBT key-value store holding zarr v2 arrays whose chunks are zstd frames.

``zstd`` binds the hand-written frame decoder (``csrc/zstd.cpp``) and
writes raw-block frames; ``ocdbt`` reads and writes the B-tree database;
``zarr`` turns arrays into keys and back; ``pytree`` saves and restores a
nested dict/list tree with orbax's ``_METADATA``.
"""
