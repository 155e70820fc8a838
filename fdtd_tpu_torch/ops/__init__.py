"""Update operators: plain torch versions (``curl``) and the Hopper kernels
(``yee``, built by ``build``)."""
