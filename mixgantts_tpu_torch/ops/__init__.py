from .masks import sequence_mask
from .words import (
    segment_ids_from_counts,
    word_level_pooling,
    length_regulate,
    mapping_mask,
    rel_position_coef,
)
from .schedules import get_noise_schedule_list
