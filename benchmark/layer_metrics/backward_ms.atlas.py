"""Stage C's backward, the reader's rematerialised layers and K1's relative-bias gradient among it. The mean of the program's stage timer's ``backward`` stage
over the traced run's steps; on the card, the device's time between the
span's two events."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "backward")
