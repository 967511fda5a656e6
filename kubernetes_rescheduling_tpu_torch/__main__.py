from kubernetes_rescheduling_tpu_torch.cli import main

raise SystemExit(main())
