"""Research/legacy layer — role of reference das/research/.

The reference's research code is the historical Couchbase path: a
size-bounded write-back cache (cache.py:60-109) over a keyed min-heap
(heap.py:12-117), driven by an incoming/outgoing-set index build
(das_couch_cached.py:59-140) that worked around Couchbase's 20 MB value
limit.  The tensor store supersedes all of it (incoming sets are a
device CSR), but the layer is carried for inventory completeness: the
cache/heap algebra is generic KV machinery, and the index build is kept as a
host-side differential oracle for the CSR.
"""
