"""Shared constants.

The port's copy of ``kindergarten_vq_vae_tpu/utils/consts.py`` (that package
cannot be imported without jax): the dataset split seed, the freezing modes,
the run-id timestamp format and the dSentences factor tables, with the
same values.
"""

DS_GEN_SEED = 69

SUPPORTED_MODEL_MODES = ("full", "dec-head-ft", "enc-head-ft-dec-head-ft", "vq-ft")

RUN_ID_TIMESTAMP_FORMAT = "%Y_%m_%d_%H_%M_%S"

# the "clean" selection of the 5-factor pipeline: raw label columns
# [2, 5, 6, 7, 8] (sentence_type, gram_num_person, negation, tense, style)
CLEAN_FACTOR_COLUMNS = (2, 5, 6, 7, 8)

# every factor is one-hotted to 3 values
FACTOR_MAX_SUPPORT = 3

# human-readable value names of the 5 clean factors, in column order
EXPLICIT_FACTOR_VALUES = {
    "sentence_type": ("declarative", "interrogative"),
    "grammatical_number_person": ("1st", "2nd", "3rd"),
    "sentence_negation": ("affirmative", "negative"),
    "verb_tense": ("past", "present", "future"),
    "sentence_style": ("not_progressive", "progressive"),
}
