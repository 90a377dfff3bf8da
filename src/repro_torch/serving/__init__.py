"""Serving (port of ``repro.serving``): the request-coalescing front-end
(``batching``) over the bucketed device search, and the kNN-softmax head
(``knn_softmax``) that retrieves a decoder's candidate tokens with it."""
