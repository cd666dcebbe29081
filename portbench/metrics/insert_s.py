"""insert_s: seconds of set-up's insert_batch calls and the first search,
which uploads the index to the device (FlatIndex._sync_device)."""


def read(run):
    return run.insert_s
