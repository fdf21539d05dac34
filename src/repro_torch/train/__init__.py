"""Training (port of ``repro.train``): the train and serve step builders
(``train_step``) and checkpoints (``checkpoint``). The reference's
``elastic`` (straggler detection and re-mesh) has no meaning on one card
and is left out."""
