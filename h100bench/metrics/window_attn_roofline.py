"""The Swin window-attention kernel's share of its roofline (bound: bytes).

The records do not carry the configuration; the metric is listed for
``sln_swin_s.detect-b1`` alone, so the bound is that configuration's
(``configs/sln_swin_s.json``, ``reference/trunks/swin_s.py``). Images are
the kernel's launches in the profiled stretch over the trunk's blocks (one
launch per block)."""

from h100bench import harness
from h100bench.readers import kernel_seconds
from h100bench.reference import trunks

CONFIG = "sln_swin_s"


def read(records):
    trunk = trunks.load("swin_s")
    secs, launches = kernel_seconds(records, (trunk.KERNEL,))
    if not launches[trunk.KERNEL] or secs <= 0:
        return None
    bound, _ = trunk.window_attention_bound_s(harness.config_file(CONFIG))
    return 100.0 * bound * launches[trunk.KERNEL] / trunk.blocks() / secs
