"""Text pipeline of the port: tokenizers, sentence/document iterators, the
vocabulary with its Huffman coding and word-vector serialization, which
Word2Vec, ParagraphVectors and GloVe (``models/``) train from; constituency
trees, the PCFG-CKY parser and the HMM POS tagger, which the RNTN trains
from; the stemmer, the sentiment lexicon, the vectorizers and the inverted
index. Host-side modules of ``deeplearning4j_tpu/nlp`` kept as the port's
own copies (the tagger decodes on a device).
"""
