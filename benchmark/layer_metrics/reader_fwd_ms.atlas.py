"""Stage C's T5 v1.1 FiD reader: the encoder over the K rows (K1 with the relative-position bias) and the decoder (``fid_encode``, ``reader.decode``). The mean of the program's stage timer's ``reader_forward`` stage
over the traced run's steps; on the card, the device's time between the
span's two events."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "reader_forward")
