"""PyTorch/CUDA port of the GSI serving system (``repro`` is the JAX reference).

The port imports ``torch``, ``numpy`` and the standard library only.  Its
entry points (:class:`repro_torch.serving.GSIServingEngine`,
:class:`repro_torch.serving.GSIScheduler`, ``repro_torch.launch.serve``)
run on a CUDA device unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper uses its plain PyTorch version.
"""
