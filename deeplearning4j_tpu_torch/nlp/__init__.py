"""Text pipeline of the port: tokenizers, sentence/document iterators, the
vocabulary with its Huffman coding, and word-vector serialization — the
pure-Python modules of ``deeplearning4j_tpu/nlp`` that Word2Vec and
ParagraphVectors (``models/``) train from, kept as the port's own copies.
"""
