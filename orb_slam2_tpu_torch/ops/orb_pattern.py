"""The OpenCV learned 256-pair rBRIEF sampling pattern (opt-in).

Port of ``orb_slam2_tpu/ops/orb_pattern.py``: the numeric table
``bit_pattern_31_`` of the reference's modified OpenCV orb.cpp
(src/ORBextractor.cc:209-470; the learned pattern of Rublee et al.,
"ORB: an efficient alternative to SIFT or SURF", ICCV 2011, shipped in
OpenCV), as the base64 of its 1024 int8 offsets.  It makes descriptors
compatible with OpenCV ORB and with ORBvoc vocabularies trained on
OpenCV descriptors.  Select with ``OrbParams(pattern="orb_learned")``;
the default remains the seeded random pattern (ops/brief.py).
"""
import base64

import numpy as np

_B64 = (
    "CP0JBQQCB/T1CfgCB/QM8wLzAgwB+QEG/vb+/PPz9fjz/fT3CgQLCfP4+Pf1B/cM"
    "BwcMBvz7/QDzAvT99wD5BQz6DP/9Bv4M+vP8+AvzDPgEBwUBBf0K/QP5Bgz4+fr+"
    "/gv/9vMM+Ar5A/v9/AL9B/b0+gsF9Ab5BfoH/wEABPsJCwvzBAcEDAL/BAT89P4H"
    "+Pv59gQLCQwA+AHz8/74Av3+/gP6Cfz3CAwKBwAJAQMH+wv28/r1AAoHDAH6/foM"
    "CvcM/PMI+PTzAPj8AwMHCAUHCvn/BwH0A/YFBgL8A/bzAPMF8/n0DPMD9Qj5DPwH"
    "BvYMCPf/+fr++wAM9AX5BQP2CPP5+fwF/f7/+QIJBfX18/vz/wYA/wX9BQL88/wM"
    "9/r3BvT2+PwKAgz9BwwMDPnz+gX8Cf0EB/8MAvkG+wHzC/QF/Qf++gf4DPnz+fX0"
    "Af0MDAL6AwD8A/7z//MBCQcBCPoB/wMMCQEMBv/3/wPz8/YFBwcKDAz7DAkGAwcL"
    "BfMGCgL0AgMDCAT6AgYM8wn0CgP4BPkJ9Qz8+gEMAvgG9wf8AgMD/gYDCwAD/Qj4"
    "BwgJA/X7+vz2C/sK+/j9DPYF9wAI/wz6BPoG9fYM+AcE/gYH/gD+DPv4+wIH+goM"
    "9/P4+Pvz+/4I+Anz9/X3AAH4Af4H/AkB/gH//Av6DPX09/oEAwcHDAUFCggA/AII"
    "9wz78wAHAgz/AgEHBQsH9wMFBvjz/PgJ+wn9/fz5/fQGBQgA+Qb6DPMG+/4B9gMK"
    "BAEI/P7+AvMC9AwM/vMA+gQBCQP69v37/fP/AQcFDPUE/gX58wn3+wcBCAYH+AcG"
    "+fz5AfgL+fjzBvT4AgQDCQr7DAP6+/oHCP0J+AL0Agj1/vYD9PP59/UA9vsF/QsI"
    "/vP/DP/4AAnz9fT79v72C/0J/vMC/QMC9/P8APwG/fb8DP75+vX8CQb9BgvzC/sF"
    "CwsMBgf7DP7/DAAH/Pj9/vkB+gfz9Pjz+f76+PgF+vf7//wF8wf4CgEFBfMBAArz"
    "CQwK/wX4Cvf/CwHz9/36Av/2AQzzAfj2CPUK+gLzA/oH8wz39vb7+fb4+PME+ggF"
    "AwwI8/wC/f0F8wr0BPMF//cJ/AMAAwP39AH6AQMCBPj29vYJCPMMDPj0+vsCAgMH"
    "CgYL+AYICPT5CvoF/ff9Cf/z/wX9+f0E+P74AwQCDAwC+wMLBvcL8wP/BwwL/wwE"
    "/QD9BgT1BAwC/AIB9vr4AfMH9QHzDPXzBgAL8wD/AQTzA/f+9wj6/fP6+P4F9wgK"
    "AgcD9//6//8JBQv+C/0M+AMAAwX/BAAKA/oEBfMA9gUFCAwLCAkJ+gf8CPT2BPYJ"
    "BwMMBAn5Cv4HAAz+//oA9Q=="
)

# (256, 4) int32: x_a, y_a, x_b, y_b per comparison pair
BIT_PATTERN_31 = (
    np.frombuffer(base64.b64decode(_B64), np.int8)
    .astype(np.int32).reshape(256, 4)
)
