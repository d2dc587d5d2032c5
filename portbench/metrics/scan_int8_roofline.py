"""scan_int8_roofline: the stage-1 scans' counted work (work/counts.py,
stage "scan_int8") at the published peaks, over the device time of the
kernels named in work/kernels/scan_int8_roofline/, in percent."""

from pbcore.readers import roofline


def read(run):
    return roofline(run, "scan_int8", "scan_int8_roofline")
