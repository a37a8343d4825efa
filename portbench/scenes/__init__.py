"""Scene geometry by dataset: ``scenes/<data.dataset>.py`` gives the
traffic generator (``traffic.py``) the cameras, the ``ratio`` and the
ground truth of that dataset's scenes, in the detector's batch layout
(``reference/detector.py``).  A module provides

* ``VIEWS``: the views of a scene;
* ``cameras(rng, b, size, train)``: ``(intrinsics (b, 3, 3), extrinsics
  (b, VIEWS, 4, 4), origins (b, 3))`` as numpy float32, ``size`` the
  image's ``(w, h)``;
* ``ratio(w)``: ``ori_h / (img_h / stride)`` at image width ``w``;
* ``ground_truth(rng, b, size, data)``: padded ``(boxes (b, G, 7),
  labels (b, G), mask (b, G))`` of ``b`` training scenes, ``data`` the
  configuration file's ``data`` object.

The numbers are drawn from ``rng``, in the order ``cameras`` then
``ground_truth``, a frozen copy of the port's synthetic batches
(``imvoxelnet_tpu_torch/utils/synthetic.py``), so that a change there
cannot move the benchmark."""
