from acmmp_spherical_torch.pipeline.cli import main

raise SystemExit(main())
