"""Core ADOTA-FL library of the port: slabs (``slab``), channel configs
and transforms (``channel``), the draws seam (``draws``), server
optimizers (``adaptive``), resident state (``slab_state``), the MAC
(``ota``) and the round (``fl``). Import from the submodules; this
package file imports nothing, so the kernels can import ``core.channel``
without a cycle."""
