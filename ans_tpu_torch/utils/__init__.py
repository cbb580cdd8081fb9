"""Host utilities: file I/O, entropy metrics, timing, stats, RNG, the
BWT / MTF transforms and device tracing (copies of ans_tpu/utils; the
tracing on torch.profiler)."""

from .io import (read_file_u32, read_file_text, write_file_u32,
                 write_file_text)  # noqa: F401
from .metrics import (compute_entropy, compute_sigma, entropy_of_freqs,
                      cross_entropy_of_freqs, compute_ips,
                      compute_mips)  # noqa: F401
from .stats import comp_stats, record_stats  # noqa: F401
from .timing import timer  # noqa: F401
