"""C-Sibelia-compatible command line driver.

Mirrors reference src/csibelia/C-Sibelia.py:509-601: runs the synteny
pipeline with the fixed flag set (-q --correctboundaries --nopostprocess
--allstages --lastk 30 -m <minblocksize> -s <preset> -i <maxiter> -r),
then calls variants and writes VCF (+ optional MAF / unmapped insertions).
The Sibelia stage runs in-process (no subprocess); block coordinate files
are written to the output directory exactly as the reference binary would
write them, then consumed by the variant caller.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from ..cli.sibelia import run as sibelia_run
from ..variants import caller


def run(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="C-Sibelia", description="A tool for comparing two microbial genomes.")
    parser.add_argument("reference")
    parser.add_argument("assembly")
    parser.add_argument("-s", "--parameters", default="fine")
    parser.add_argument("-m", "--minblocksize", type=int, default=500)
    parser.add_argument("-p", "--processcount", type=int, default=1)
    parser.add_argument("-i", "--maxiterations", type=int, default=4)
    parser.add_argument("--maf")
    parser.add_argument("-v", "--variant", default="variant.vcf")
    parser.add_argument("-u", "--unmapped", type=str)
    parser.add_argument("--debug", action="store_true")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("-t", "--tempdir")
    group.add_argument("-o", "--outdir")
    args = parser.parse_args(argv)
    from ..core.platform import enable_compile_cache
    enable_compile_cache()

    cleanup = False
    if args.outdir is None:
        if args.tempdir is None:
            temp_dir = tempfile.mkdtemp(dir=".")
            cleanup = True
        else:
            temp_dir = args.tempdir
    else:
        temp_dir = args.outdir

    try:
        print("Calculating synteny blocks...", file=sys.stderr)
        rc = sibelia_run([
            args.reference, args.assembly,
            "-q", "--correctboundaries", "--nopostprocess", "--allstages",
            "--lastk", "30", "-m", str(args.minblocksize), "-o", temp_dir,
            "-s", args.parameters, "-i", str(args.maxiterations), "-r"])
        if rc != 0:
            raise RuntimeError("synteny stage failed")

        genomes = (caller.parse_fasta_file(args.reference)
                   + caller.parse_fasta_file(args.assembly))
        reference = caller.parse_fasta_file(args.reference)
        assembly = caller.parse_fasta_file(args.assembly)
        reference_seq = {r.id: r.seq for r in reference}
        assembly_seq = {r.id: r.seq for r in assembly}
        reference_organism = reference[0]
        all_seq = sorted([r.id for r in reference] + [r.id for r in assembly])
        for i in range(len(all_seq) - 1):
            if all_seq[i] == all_seq[i + 1]:
                raise RuntimeError(f'Found duplicated sequence id "{all_seq[i]}"')

        print("Calling variants...", file=sys.stderr)
        variant_list, insertion_list, alignment_list = caller.call_variants(
            temp_dir, genomes, reference_seq, assembly_seq,
            args.minblocksize, align=args.maf is not None,
            processes=args.processcount)
        variant_list.sort(key=caller.variant_key)
        vcf_file = (args.variant if args.outdir is None
                    else os.path.join(args.outdir, args.variant))
        with open(vcf_file, "w") as vcf_out:
            caller.write_vcf_header(reference_organism, vcf_out)
            if args.unmapped is not None:
                ins_file = (args.unmapped if args.outdir is None
                            else os.path.join(args.outdir, args.unmapped))
                caller.write_insertions_fasta(insertion_list, ins_file)
            else:
                caller.write_insertions_vcf(insertion_list, reference_organism, vcf_out)
            caller.write_variants_vcf(variant_list, vcf_out)

        if args.debug:
            conv = ("variant.txt" if args.outdir is None
                    else os.path.join(args.outdir, "variant.txt"))
            with open(conv, "w") as h:
                for v in variant_list:
                    h.write(str(v) + "\n")
                for v in insertion_list:
                    h.write(str(v) + "\n")

        if args.maf is not None:
            maf_file = (args.maf if args.outdir is None
                        else os.path.join(args.outdir, args.maf))
            with open(maf_file, "w") as h:
                caller.write_alignments_maf(alignment_list, h)
        return 0
    finally:
        if cleanup:
            shutil.rmtree(temp_dir, ignore_errors=True)


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
