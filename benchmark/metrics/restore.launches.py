"""Device kernels launched inside the restore's ``unwarp`` step (the
port's ``client.restore`` span outside its ``client.upload`` and
``client.readback``), per restore: the unwarp's per-axis vector math and
``unwarp_xy``."""

from benchmark.trace import launches


def read(trace):
    return launches(trace, "unwarp")
