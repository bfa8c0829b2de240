"""CLI: `python -m rssync_tpu.pipeline <recipe.json> [options]`.

The reference executable takes exactly one JSON recipe path
(ref: README.md:14, core_testcode.cpp:251); options beyond that are
rebuild extensions (tracker choice, batching, guess-orient mode).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="rssync_tpu.pipeline",
        description="GPU gyro-to-video sync (rs-sync recipe format)",
    )
    ap.add_argument("recipe", nargs="+",
                    help="JSON recipe path (times in ms); several paths "
                         "with --multi")
    ap.add_argument("--multi", action="store_true",
                    help="sync all given recipes as ONE batched engine run "
                         "(N clips x M syncpoints on a single window axis; "
                         "shardable over a device mesh)")
    ap.add_argument("--method", choices=["lk", "dis"], default="lk",
                    help="tracker: on-device pyramidal LK (default) or host cv2 DIS")
    ap.add_argument("--sequential", action="store_true",
                    help="per-syncpoint loop instead of batched launches")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="print the reference's per-iteration `delay step` "
                         "lines for every window (batched mode reads them "
                         "from the sync trace buffers)")
    ap.add_argument("--track-cache", metavar="DIR", default=None,
                    help="cache the track stage to DIR (skip re-decoding "
                         "video on repeated runs)")
    ap.add_argument("--full-decode", action="store_true",
                    help="decode/track the whole frame_range like the "
                         "reference instead of only syncpoint-window pairs "
                         "(identical outputs; slower host decode)")
    ap.add_argument("--guess-orient", action="store_true",
                    help="rank all 48 gyro orientation variants by PreSync "
                         "cost instead of running the sync pipeline")
    ap.add_argument("--frames", type=int, nargs=2, metavar=("BEGIN", "END"),
                    help="frame range override for --guess-orient")
    args = ap.parse_args(argv)

    from rssync_tpu.utils.timing import enable_compile_cache

    enable_compile_cache()

    if args.guess_orient:
        from rssync_tpu.pipeline.guess_orient import run_guess_orient

        results = run_guess_orient(
            args.recipe[0], frames=args.frames, method=args.method,
            seed=args.seed, progress=not args.quiet,
        )
        print("\n----- Top-5 results -----")
        for cost, _delay, orient in results[:5]:
            print(f"{orient} {cost:g}")
        return 0

    if args.multi or len(args.recipe) > 1:
        from rssync_tpu.pipeline.recipe import run_multi_recipes

        results = run_multi_recipes(
            args.recipe, method=args.method, seed=args.seed,
            progress=not args.quiet, track_cache_dir=args.track_cache,
            decode_scope="full" if args.full_decode else "windows",
        )
        for path, res in zip(args.recipe, results):
            for pos, dms in zip(res.syncpoints, res.delays_ms):
                print(f"{path},{pos},{dms:g}")
        return 0

    from rssync_tpu.pipeline.recipe import run_recipe

    result = run_recipe(
        args.recipe[0], method=args.method, seed=args.seed,
        batched=not args.sequential, progress=not args.quiet,
        track_cache_dir=args.track_cache, trace=args.trace,
        decode_scope="full" if args.full_decode else "windows",
    )
    for pos, dms in zip(result.syncpoints, result.delays_ms):
        print(f"{pos},{dms:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
