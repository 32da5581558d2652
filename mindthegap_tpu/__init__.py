"""mindthegap_tpu — an insertion-variant caller and genome gap-filler on JAX/XLA.

A from-scratch reimplementation of the capabilities of GATB/MindTheGap
(AGPL, INRIA Genscale) whose hot loops run on an accelerator:

- k-mer extraction, counting, and de Bruijn graph membership are vectorized
  device ops (plain JAX/XLA programs, compiled for the GPU by XLA);
- the `find` reference scan is a device pass producing per-position
  "plane" tensors (membership / in-out degree / repeat bits), replayed by an
  exact host automaton on the sparse gap events;
- the `fill` local assembly is a batched frontier expansion with host path
  enumeration on the tiny per-breakpoint contig graphs;
- multi-device scaling uses jax.sharding Mesh + collectives (XLA hands
  them to NCCL on GPUs; no MPI).

The package keeps MindTheGap's CLI surface, file formats and defaults
(see reference src/Finder.cpp:97-171, src/Filler.cpp:76-113) so it is a
drop-in replacement validated against the reference golden test suites.
"""

import jax as _jax

# K-mers up to k=32 are carried in uint64 words host-side; device code uses
# explicit dtypes everywhere, but searchsorted/sort on u64 keys require x64.
_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

# Version string of the reference tool whose behavior we reproduce
# (reference src/main.cpp:29).
MTG_COMPAT_VERSION = "2.3.0"

KSIZE_LIST = (32, 64, 96, 128)  # supported kmer-size spans (reference CMakeLists.txt:62)
KSIZE_STRING = " ".join(str(x) for x in KSIZE_LIST)
