"""Corpus parsing, offline features and the training loader."""
from .dataset import (Example, parse_transcript, load_dataset_index,  # noqa
                      prepro_corpus, TrainLoader)
