"""scan_binary_roofline: the stage-1 scans' counted work (work/counts.py,
stage "scan_binary") at the published peaks, over the device time of the
kernels named in work/kernels/scan_binary_roofline/, in percent."""

from pbcore.readers import roofline


def read(run):
    return roofline(run, "scan_binary", "scan_binary_roofline")
