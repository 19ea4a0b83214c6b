"""Model families, one file each, found by a configuration's ``family``
(``manifest.family``): the family's part of the parameter layout and the
sizes the metrics count from.

  WIDTHS             the keys a configuration file of the family states
  layout(c)          the family's part of the parameter tree, as
                     ``weights.Leaf``s in draw order (after the embedding,
                     the final norm and the unembedding)
  matmul_weights(c)  weights of the products one prompt token passes, the
                     unembedding left out; a shared block counts once for
                     each site where it fires
  attention(c)       (sites, H, KV, hd): the causal-attention launches of
                     one prefill and their shape
  ssd_blocks(c)      the ``ssd_scan`` launches of one prefill

A family's plain reference is ``bench/reference/<family>.py``.
"""
