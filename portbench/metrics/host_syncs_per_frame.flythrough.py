"""Synchronising CUDA runtime calls (names holding "Synchronize") in the
traced call, per frame; the profile leaves out the synchronise with which
the benchmark closes the traced window."""


def read(record):
    prof, units = record.get("profile"), record.get("units")
    if prof is None or not prof["runtime"] or not units:
        return None
    syncs = sum(n for name, n in prof["runtime"].items()
                if "Synchronize" in name)
    return syncs / units
