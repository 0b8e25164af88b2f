"""Host clock, with a device synchronize on either side, around FLuID's
calibration in set-up: the FFN snapshot, the unit statistics and
build_masks."""


def read(run):
    return 1e3 * run.calibration_s if run.kind == "train" else None
