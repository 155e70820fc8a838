"""Update operators: plain torch versions (``curl``, ``stream.plain_sweep``)
and the Hopper kernels (``yee``, two-pass; ``stream``, the s-step sweep
planned by ``stream_plan``; built by ``build``)."""
