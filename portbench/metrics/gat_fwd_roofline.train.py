"""The plan attention's fwd kernel, plan_gat_fwd_kernel: least time of its work (the family's count) over its device time in the traced stretch, in %."""
from portbench.families.gat import kernel_roofline


def read(run):
    return kernel_roofline(run, "plan_gat_fwd_kernel")
