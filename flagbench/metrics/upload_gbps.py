"""GB/s of the stream's uploads: bytes uploaded over the summed spans of its own upload events."""


def read(cell):
    seconds = cell.counters.get("upload_s")
    if not seconds:
        return None
    return cell.counters["upload_bytes"] / seconds / 1e9
