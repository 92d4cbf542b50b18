"""Bag-of-binary-words place recognition on torch tensors (counterpart of
the JAX package's ``vocab``): the vocabulary tree and its transform
(``bow``), and the keyframe database with its candidate queries
(``kfdb``)."""
