"""Multi-chip scaling layer: mesh construction, sharded Welch (SP/DP with
ppermute halos + psum averaging), time-sharded overlap-save FIR, and the
distributed four-step FFT (TP with all-to-all transposes)."""

from .mesh import make_mesh, shard_map, P, Mesh, NamedSharding
from .welch import welch_psd_sharded, plan_shard_segments
from .fir import fir_filter_sharded
from .fft import (fft_sharded, ifft_sharded, rfft_sharded, irfft_sharded,
                  hilbert_sharded,
                  axis_swap, four_step_factor)
from .runtime import (init_distributed, make_host_mesh, scaling_report,
                      measure_scaling, audit_collectives, audit_mesh_paths)
from .stft import stft_sharded, specgram_sharded

__all__ = ["make_mesh", "shard_map", "P", "Mesh", "NamedSharding",
           "welch_psd_sharded", "plan_shard_segments", "fir_filter_sharded",
           "fft_sharded", "ifft_sharded", "rfft_sharded", "irfft_sharded",
           "hilbert_sharded",
           "axis_swap", "four_step_factor",
           "init_distributed", "make_host_mesh", "scaling_report",
           "measure_scaling", "audit_collectives", "audit_mesh_paths",
           "stft_sharded", "specgram_sharded"]
