"""kernel_roofline.sort: the bitonic kernels' share of their roofline in
the profiled stretch of sorts (kernels/bitonic.py, csrc/bitonic.cu).

For every call of the port's four bitonic ops the bound is the bytes it
must move at its shapes, each input byte read once and each output byte
written once (``counts.bitonic_bytes``, shapes from the profiler's
``record_shapes`` in the run's sort traced with shapes), over the card's 3.35
TB/s; the share is the summed bounds over the summed device time of the
bitonic kernels in that stretch. Each kernel is paired with the op call
that launched it (``Profile.launched_by``: the profiler's correlation id
to the launch, the launch inside the op's call on the host's clock), and
only paired calls and kernels count, so no op's bytes are counted without
its kernel's time, nor a kernel's time left out where the card's clock
and the host's disagree at the stretch's ends."""
from benchlib import counts

OPS = {"repro_torch::" + op: op for op in ("sort_rows", "sort_rows_kv", "merge_rows",
                                            "merge_rows_kv")}


def _is_bitonic_kernel(name: str) -> bool:
    return "sort_rows_kernel" in name or "merge_rows_kernel" in name


def read(r):
    p, peak = r.shapes, counts.PEAKS.get(r.device_kind)
    if p is None or peak is None:
        return None
    paired = p.launched_by(_is_bitonic_kernel, OPS)
    calls = {id(o): o for o, _ in paired}.values()
    moved = sum(counts.bitonic_bytes(OPS[o["name"]], o["dims"], o["types"]) for o in calls)
    seconds = sum(s for _, s in paired)
    if moved == 0 or seconds == 0:
        return None
    return 100.0 * (moved / peak["hbm_bytes_s"]) / seconds
