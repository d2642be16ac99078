"""Application entry points, mirroring the reference CLIs:

  python -m reconplan_tpu.apps.redundancy ur10 rot_variable_yaw
      (reference: ``python redundancy.py ur10 rot_variable_yaw``)
  python -m reconplan_tpu.apps.scan
      (reference: ``python main.py`` — scan-plan-capture-stitch/fuse)
  python -m reconplan_tpu.apps.stitch <capture_dir>
      (reference: ``python stitcher.py``)
  python -m reconplan_tpu.apps.eval_roadmap ur10 rot_variable_yaw
      (reference: ``python experiment/roadmap_quality.py``)

Every ``main()`` enables JAX's persistent compilation cache
(``utils.compile_cache``): the roadmap builder's batched-IK buckets take
tens of seconds of XLA compile each on a first run.
"""
