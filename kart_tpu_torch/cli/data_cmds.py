"""``kart build-annotations``: count the feature changes of HEAD's history
into the annotations cache (:meth:`kart_tpu_torch.annotations
.DiffAnnotations.build_all`), each commit diffed against its first parent
on the CLI's device.

Counterpart of kart_tpu's ``cli/data_cmds.py`` ``build-annotations``: the
same option and output line. kart_tpu's other data commands are not
ported.
"""

from kart_tpu_torch.cli.parser import Command, Option


def commands():
    return [
        Command("build-annotations", [
            Option("--all-reachable", dest="all_reachable", kind="flag"),
        ], run_build_annotations, help="Pre-compute diff feature-count annotations for commits."),
    ]


def run_build_annotations(args, repo, device):
    from kart_tpu_torch.annotations import DiffAnnotations

    built = DiffAnnotations(repo).build_all(all_reachable=args.all_reachable, device=device)
    print(f"Built annotations for {built} commit(s)")
    return 0
