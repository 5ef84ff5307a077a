"""Synthetic dSentences generator (numpy only).

The port's copy of ``kindergarten_vq_vae_tpu/data/generate.py``, which
cannot be imported without jax (its package ``__init__`` pulls it in): the
same factorial corpus of 9 generative factors in the reference's raw order,
the same sentences in the same order and the same ``(N, 9)`` int64 labels,
written as ``dSentences_sentences.npy`` (bytes) and
``dSentences_latent_classes_labels.npy``. As in the real corpus, many
factor combinations collapse to one surface sentence (gender is inert
outside the 3rd person singular); ``data/prepare.py`` dedups them.
"""

from __future__ import annotations

import os

import numpy as np

FACTOR_SUPPORTS = (2, 2, 2, 2, 2, 3, 2, 3, 2)

# verb pools keyed by verb_obj_interaction; forms: base, 3rd-sg present, past,
# -ing participle. Pool sizes (20 verbs x 21 objects per class) put the full
# factorial at 2*20*21*576 = 483,840 raw -> 241,920 unique after the gender/
# you-number surface collapse (exactly half: gender is inert outside 3rd-sg
# and "you" sg/pl share a surface form) — the reference corpus's ~235k+
# regime: its cross-attention extract consumes 69 x 2048 = 141k sentences of
# the 60% train split (which is 145k here),
# analyses/cross_attention/extract_model_cross_attention.py:59-60.
# Verb/object identity within a pool is deliberately NOT a labeled factor,
# matching real dSentences content variation.
_VERBS = (
    (
        ("eat", "eats", "ate", "eating"),
        ("cook", "cooks", "cooked", "cooking"),
        ("buy", "buys", "bought", "buying"),
        ("taste", "tastes", "tasted", "tasting"),
        ("like", "likes", "liked", "liking"),
        ("want", "wants", "wanted", "wanting"),
        ("serve", "serves", "served", "serving"),
        ("order", "orders", "ordered", "ordering"),
        ("share", "shares", "shared", "sharing"),
        ("enjoy", "enjoys", "enjoyed", "enjoying"),
        ("prepare", "prepares", "prepared", "preparing"),
        ("sell", "sells", "sold", "selling"),
        ("slice", "slices", "sliced", "slicing"),
        ("bake", "bakes", "baked", "baking"),
        ("grab", "grabs", "grabbed", "grabbing"),
        ("choose", "chooses", "chose", "choosing"),
        ("smell", "smells", "smelled", "smelling"),
        ("pick", "picks", "picked", "picking"),
        ("steal", "steals", "stole", "stealing"),
        ("deliver", "delivers", "delivered", "delivering"),
    ),
    (
        ("build", "builds", "built", "building"),
        ("paint", "paints", "painted", "painting"),
        ("clean", "cleans", "cleaned", "cleaning"),
        ("move", "moves", "moved", "moving"),
        ("fix", "fixes", "fixed", "fixing"),
        ("repair", "repairs", "repaired", "repairing"),
        ("design", "designs", "designed", "designing"),
        ("measure", "measures", "measured", "measuring"),
        ("inspect", "inspects", "inspected", "inspecting"),
        ("destroy", "destroys", "destroyed", "destroying"),
        ("decorate", "decorates", "decorated", "decorating"),
        ("polish", "polishes", "polished", "polishing"),
        ("draw", "draws", "drew", "drawing"),
        ("lift", "lifts", "lifted", "lifting"),
        ("push", "pushes", "pushed", "pushing"),
        ("examine", "examines", "examined", "examining"),
        ("restore", "restores", "restored", "restoring"),
        ("wash", "washes", "washed", "washing"),
        ("carry", "carries", "carried", "carrying"),
        ("open", "opens", "opened", "opening"),
    ),
)

_OBJECTS = (
    (
        ("apple", "apples"), ("cake", "cakes"), ("mango", "mangoes"),
        ("salad", "salads"), ("pizza", "pizzas"), ("banana", "bananas"),
        ("cookie", "cookies"), ("sandwich", "sandwiches"), ("soup", "soups"),
        ("pie", "pies"), ("orange", "oranges"), ("lemon", "lemons"),
        ("burger", "burgers"), ("pancake", "pancakes"), ("muffin", "muffins"),
        ("tomato", "tomatoes"), ("carrot", "carrots"), ("pear", "pears"),
        ("melon", "melons"), ("peach", "peaches"), ("grape", "grapes"),
    ),
    (
        ("chair", "chairs"), ("house", "houses"), ("wall", "walls"),
        ("fence", "fences"), ("table", "tables"), ("door", "doors"),
        ("window", "windows"), ("roof", "roofs"), ("floor", "floors"),
        ("cabin", "cabins"), ("bridge", "bridges"), ("tower", "towers"),
        ("shed", "sheds"), ("gate", "gates"), ("bench", "benches"),
        ("garage", "garages"), ("ladder", "ladders"), ("porch", "porches"),
        ("pillar", "pillars"), ("cottage", "cottages"), ("barn", "barns"),
    ),
)


def _subject(person: int, number: int, gender: int) -> str:
    if person == 0:
        return "i" if number == 0 else "we"
    if person == 1:
        return "you"
    if number == 1:
        return "they"
    return "he" if gender == 0 else "she"


def _be_form(subj: str, tense: int) -> str:
    """Conjugated 'be' auxiliary for the progressive style."""
    if tense == 0:  # past
        return "was" if subj in ("i", "he", "she") else "were"
    # present (future uses "will be" handled by caller)
    if subj == "i":
        return "am"
    if subj in ("he", "she"):
        return "is"
    return "are"


def _render(subj: str, verb, obj: str, sentence_type: int, negation: int, tense: int, style: int) -> str:
    base, s3, past, ing = verb
    third_sg = subj in ("he", "she")
    neg = negation == 1
    interrog = sentence_type == 1

    if style == 1:  # progressive
        if tense == 2:  # future
            if interrog:
                words = ["will", subj] + (["not"] if neg else []) + ["be", ing, obj]
            else:
                words = [subj, "will"] + (["not"] if neg else []) + ["be", ing, obj]
        else:
            be = _be_form(subj, tense)
            if interrog:
                words = [be, subj] + (["not"] if neg else []) + [ing, obj]
            else:
                words = [subj, be] + (["not"] if neg else []) + [ing, obj]
    else:  # simple
        if tense == 2:  # future
            if interrog:
                words = ["will", subj] + (["not"] if neg else []) + [base, obj]
            else:
                words = [subj, "will"] + (["not"] if neg else []) + [base, obj]
        elif tense == 0:  # past
            if interrog or neg:
                aux = "did"
                if interrog:
                    words = [aux, subj] + (["not"] if neg else []) + [base, obj]
                else:
                    words = [subj, aux, "not", base, obj]
            else:
                words = [subj, past, obj]
        else:  # present
            if interrog or neg:
                aux = "does" if third_sg else "do"
                if interrog:
                    words = [aux, subj] + (["not"] if neg else []) + [base, obj]
                else:
                    words = [subj, aux, "not", base, obj]
            else:
                words = [subj, s3 if third_sg else base, obj]

    return " ".join(words)


def generate_dsentences(
    out_dir: str | None = None,
    num_verbs: int = len(_VERBS[0]),
    num_objects: int = len(_OBJECTS[0]),
):
    """Generate the full factorial corpus.

    Returns ``(sentences, labels)`` where ``sentences`` is a list of str and
    ``labels`` is an int64 array of shape (N, 9). When ``out_dir`` is given,
    writes ``dSentences_sentences.npy`` (bytes, matching the reference's raw
    artifact read via ``.decode()`` in dSentences_clean_dataset.py:13) and
    ``dSentences_latent_classes_labels.npy``.
    """
    sentences: list[str] = []
    labels: list[tuple] = []
    for voi in range(FACTOR_SUPPORTS[0]):
        verbs = _VERBS[voi][:num_verbs]
        objects = _OBJECTS[voi][:num_objects]
        for v_i, verb in enumerate(verbs):
            for o_i, obj_forms in enumerate(objects):
                for num_obj in range(FACTOR_SUPPORTS[1]):
                    obj = "the " + obj_forms[num_obj]
                    for stype in range(FACTOR_SUPPORTS[2]):
                        for gender in range(FACTOR_SUPPORTS[3]):
                            for num_subj in range(FACTOR_SUPPORTS[4]):
                                for person in range(FACTOR_SUPPORTS[5]):
                                    subj = _subject(person, num_subj, gender)
                                    for neg in range(FACTOR_SUPPORTS[6]):
                                        for tense in range(FACTOR_SUPPORTS[7]):
                                            for style in range(FACTOR_SUPPORTS[8]):
                                                sentences.append(
                                                    _render(subj, verb, obj, stype, neg, tense, style)
                                                )
                                                labels.append(
                                                    (voi, num_obj, stype, gender, num_subj, person, neg, tense, style)
                                                )

    labels_arr = np.asarray(labels, dtype=np.int64)

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        np.save(
            os.path.join(out_dir, "dSentences_sentences.npy"),
            np.asarray([s.encode() for s in sentences]),
        )
        np.save(os.path.join(out_dir, "dSentences_latent_classes_labels.npy"), labels_arr)

    return sentences, labels_arr
