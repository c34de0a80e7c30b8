from repro_torch.data.corpora import (forest_like, dblife_like, citeseer_like,
                                      cora_like, multiclass_corpus,
                                      multiclass_example_stream,
                                      MulticlassCorpus, synthetic_corpus,
                                      example_stream, Corpus)
