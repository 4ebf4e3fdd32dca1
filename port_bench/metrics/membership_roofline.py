"""``membership``'s share of its roofline over the traced window: the least
time of every step's scoring (``roofline.membership_least_time``: 2·E
operations a scored (slot, doc) pair at the bf16 dense peak, or the bf16
doc table, slot rows and result words moved once at HBM bandwidth) over the
kernel's device time in the profile."""

KERNEL = "membership_kernel"


def read(rec):
    kernel_s = sum(t for n, t in rec.get("kernel_s", {}).items() if KERNEL in n)
    if not kernel_s:
        return None
    return 100.0 * sum(w["least_s"] for w in rec["stepped"]) / kernel_s
