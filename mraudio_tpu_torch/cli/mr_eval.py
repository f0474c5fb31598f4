"""Scoring CLI, an alias of ``mraudio_tpu_torch.eval.mr_eval:eval_main``:

    python -m mraudio_tpu_torch.cli.mr_eval --submission_path P.jsonl \\
        --gt_path A.jsonl --save_path metrics.json [--not_verbose]
"""

from mraudio_tpu_torch.eval.mr_eval import eval_main

if __name__ == "__main__":
    eval_main()
